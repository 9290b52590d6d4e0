#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds (stdout flushed, the
device synchronised at the end of each):

1. device  -- CUDA present; the card's name and power limit (nvidia-smi).
2. build   -- one nvcc call builds semantic_slam_master_tpu_torch/csrc/*.cu.
3. fast_score / 4. gather_aligned_patches / 5. gather_patches -- each
   kernel against its plain PyTorch version at the main paths' shapes
   (FAST-9 decisions and patches exact, scores within 1e-6 relative;
   gather_patches in both modes: the learned path's 8x500 windows of
   radius 10, the padded 32x32 mode at N=8192, and ragged cases with N % 8
   != 0 and border centres), timed with CUDA events (median of 20
   launches after warm-up, L2 flushed between launches, host enqueue time
   hidden behind a device spin) beside its bound, the plain version's
   time and, for the gathers, one ``torch.gather`` over the precomputed
   flat index (the gather alone). A gather's bound counts the distinct
   source pixels its windows cover, read once, plus its output.
6. ORB frontend -- extract_features on two 640x480 frames on the card
   against the same call on the CPU (the plain versions of both
   kernels), and on two frames of the dynamic world with the GT
   class-weight map, which must change the detections and down-weight
   some keypoints on the card as on the CPU.
7. ORB main path -- ``run-slam --synthetic`` at 640x480 with the defaults
   (512 keypoints, 2048 landmarks, window 5, 4 BA iterations, 16-frame
   frontend chunks), then ``evaluate``; ATE finite and below 0.05 m, both
   ORB kernels launched 4x per frontend chunk.
8. learned frontend + segmenter -- the ViT-S/16 frontend of
   configs/train_vits_synthetic_long.yaml (its offset head's last conv
   given seeded non-zero weights, so sub-patch offsets are not all 0) and
   the segmenter, seeded alike, on two 640x480 frames on the card against
   the CPU: saliency max abs difference <= 0.02; >= 90% of the
   patch-centre keypoints selected by both; the sub-patch refinement on
   the CPU's inputs: mean |offset| >= 0.5 px and >= 99% of offsets
   within 1e-3 px of the CPU's; >= 90% of the refined keypoints within
   0.5 px of a CPU one (bf16 vs f32 of the same model on the CPU is
   printed beside it as the yardstick); descriptor cosine >= 0.99 on
   average and >= 0.9 at worst over keypoint pairs within 0.05 px; >=
   99% of the segmenter's 1/4-resolution labels agree (bf16 rounds at
   other places on the card; a near-tie in saliency rank can move a
   keypoint).
9. learned path -- ``run-slam --synthetic --frontend learned
   --train-config configs/train_vits_synthetic_long.yaml --semantics
   model`` (ViT-S/16 at full width with sub-patch refinement, seeded
   weights, 8-frame chunks), 60 frames, then ``evaluate``: finite poses, a
   successful evaluation, gather_patches launched at least once per
   chunk; fps and the time split (segmenter, backbone, heads, SLAM loop)
   printed. ATE is not bounded: the weights are seeded, not trained.
10. dynamic path -- ``run-slam --synthetic --dynamic --semantics gt`` (ORB
   frontend, so the weight map and score weight run through both ORB
   kernels), 60 frames, ATE below DYNAMIC_ATE_BOUND_M.

Then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``. Every failure raises, so the exit code
is non-zero and the last line is not printed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
MAIN_FRAMES = 60  # the run-slam default; not cut
TIMED_ITERS = 20
WARMUP_ITERS = 3
PLAIN_ITERS = 5
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers the host's enqueue
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# non-tensor-core float32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FAST-9 float32 work per pixel: 16 circle points x (difference, two
# compares, bright: subtract + max + add, dark: negate + subtract + max +
# add) plus the final select-add-select.
FAST_F32_OPS_PER_PIXEL = 16 * 10 + 3
# Patch gather: quantise (max, min, multiply, round) per gathered pixel.
PATCH_F32_OPS_PER_PIXEL = 4

# run-slam --synthetic --dynamic --semantics gt, 60 frames at 640x480: the
# JAX package's own ATE on the CPU is 0.0155 m (seed 0; 0.0172, 0.0258,
# 0.0174 m for seeds 1-3); the port draws other RANSAC samples, so the
# bound is twice the worst of those four.
DYNAMIC_ATE_BOUND_M = 0.05
LEARNED_CONFIG = "configs/train_vits_synthetic_long.yaml"
# gather_patches cases: (wrapper, (B, H, W), N, radius). The first is the
# learned path's call per 8-frame chunk (500 keypoints, 21x21 windows);
# the kernels line reports it.
GATHER_CASES = [
    ("gather_patches", (8, 480, 640), 500, 10),
    ("gather_patches_padded", (1, 480, 640), 8192, 15),
    ("gather_patches", (2, 83, 300), 37, 10),
    ("gather_patches_padded", (2, 83, 300), 37, 15),
]

FAST_SHAPES = [(16, 480, 640), (16, 400, 544), (16, 336, 448), (16, 280, 384)]
FAST_RAGGED = (2, 83, 300)
PATCH_CASES = [((16, 480, 640), 202), ((16, 400, 544), 142), ((16, 336, 448), 98), ((16, 280, 384), 70)]

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    import torch

    log(f"[phase] {name} ...")
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"[phase] {name} done in {time.perf_counter() - t0:.2f} s "
        f"(total {time.perf_counter() - T_START:.2f} s)")


def median_ms(fn, iters: int, warmup: int, flush) -> float:
    """Median device time of ``fn()`` over ``iters`` launches (CUDA events),
    with the L2 cache flushed before each launch. A spin on the device
    after the flush keeps the stream busy while the host enqueues the
    start event and ``fn``'s launches, so the host's enqueue time does not
    count as device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def unique_pixels(idx, n_pixels: int) -> int:
    """Distinct source pixels that the flat indices ``idx`` (B, L) touch
    in B frames of ``n_pixels``: what a gather must read at least once,
    however much its windows overlap."""
    import torch

    seen = torch.zeros((idx.shape[0], n_pixels), dtype=torch.bool, device=idx.device)
    seen.scatter_(1, idx, True)
    return int(seen.sum())


def bound(bytes_moved: float, f32_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fast(torch, kfast, gen, flush) -> dict:
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0, "max_abs_err": 0.0}
    for shape in FAST_SHAPES + [FAST_RAGGED]:
        # Smooth random texture: a coarse uniform grid upsampled, plus
        # fine noise, so corners are neither absent nor everywhere.
        B, H, W = shape
        coarse = torch.rand((B, 1, H // 8 + 1, W // 8 + 1), generator=gen, device="cuda")
        img = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear")[:, 0]
        img = (img + 0.05 * torch.rand((B, H, W), generator=gen, device="cuda")).clamp(0, 1)
        img = img.contiguous()
        got = kfast.fast_score(img, 0.05)
        ref = kfast.fast_score_plain(img, 0.05)
        torch.cuda.synchronize()
        if not torch.equal(got > 0, ref > 0):
            raise AssertionError(f"fast_score {shape}: segment-test decisions differ")
        err = (got - ref).abs().max().item()
        if not torch.allclose(got, ref, rtol=1e-6, atol=0.0):
            raise AssertionError(f"fast_score {shape}: max |kernel - plain| = {err}")
        n_corners = int((got > 0).sum())
        ms = median_ms(lambda: kfast.fast_score(img, 0.05), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kfast.fast_score_plain(img, 0.05), PLAIN_ITERS, 1, flush)
        px = B * H * W
        b_ms, b_by = bound(8.0 * px, FAST_F32_OPS_PER_PIXEL * px)
        log(f"  fast_score {shape}: exact={err == 0.0} max_abs_err={err:.3g} "
            f"corners={n_corners} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f}")
        if shape in FAST_SHAPES:
            total["ms"] += ms
            total["plain_ms"] += plain_ms
            total["bytes"] += 8.0 * px
            total["ops"] += FAST_F32_OPS_PER_PIXEL * px
        total["max_abs_err"] = max(total["max_abs_err"], err)
    return total


def check_patches(torch, kpatch, gen, flush) -> dict:
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0, "max_abs_err": 0.0}
    for (B, H, W), N in PATCH_CASES:
        img = torch.rand((B, H, W), generator=gen, device="cuda") * 1.2 - 0.1
        xy = torch.rand((B, N, 2), generator=gen, device="cuda")
        xy = xy * torch.tensor([W + 10.0, H + 10.0], device="cuda") - 5.0
        # Keypoints on and beyond every clamp edge, and on half-pixel ties.
        edges = torch.tensor(
            [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 18.0, H - 17.0], [W - 17.5, H - 16.5],
             [14.5, 15.5], [15.0, 15.0], [-3.0, H + 3.0], [W / 2 + 0.5, H / 2 - 0.5]],
            device="cuda",
        )
        xy[:, : len(edges)] = edges
        got = kpatch.gather_aligned_patches(img, xy)
        ref = kpatch.gather_aligned_patches_plain(img, xy)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or got.shape != (B, N, 32, 32):
            raise AssertionError(f"patches {(B, H, W, N)}: {got.dtype} {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"patches {(B, H, W, N)}: kernel != plain (max err {err})")
        ms = median_ms(lambda: kpatch.gather_aligned_patches(img, xy), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kpatch.gather_aligned_patches_plain(img, xy), PLAIN_ITERS, 1, flush)
        cx, cy = kpatch.patch_centers(xy, H, W)
        d = torch.arange(32, device="cuda") - 15
        idx = ((cy[..., None, None] + d[:, None]) * W + cx[..., None, None] + d[None, :]).reshape(B, -1)
        flat = img.reshape(B, H * W)
        library_ms = median_ms(lambda: torch.gather(flat, 1, idx), TIMED_ITERS, WARMUP_ITERS, flush)
        # The distinct f32 pixels the windows cover read once, 8 B of xy
        # per keypoint, a 32x32 bf16 patch written per keypoint.
        n_read = unique_pixels(idx, H * W)
        nbytes = n_read * 4 + B * N * (8 + 32 * 32 * 2)
        ops = B * N * 32 * 32 * PATCH_F32_OPS_PER_PIXEL
        b_ms, b_by = bound(nbytes, ops)
        log(f"  gather_aligned_patches {(B, H, W)} N={N}: exact=True ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"share_of_bound={b_ms / ms:.3f} distinct_pixels_read={n_read} "
            f"window_pixels={B * N * 32 * 32}")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["library_ms"] += library_ms
        total["bytes"] += nbytes
        total["ops"] += ops
        total["max_abs_err"] = max(total["max_abs_err"], err)
    return total


def check_gather(torch, kgather, gen, flush) -> dict:
    """gather_patches in both modes against its plain version, bit-exact;
    the first case (the learned path's shape) is timed for the kernels
    line."""
    report = {"max_abs_err": 0.0}
    for i, (wrapper, (B, H, W), N, radius) in enumerate(GATHER_CASES):
        side = 2 * radius + 1 if wrapper == "gather_patches" else kgather.PADDED_SIDE
        img = torch.randn((B, H, W), generator=gen, device="cuda")
        if i == 0:  # distinct patch-centre pixels of the 30x40 grid, as the learned path's top-k gives
            cells = torch.stack([torch.randperm((H // 16) * (W // 16), generator=gen, device="cuda")[:N]
                                 for _ in range(B)])
            xy = torch.stack([cells % (W // 16), cells // (W // 16)], -1).float() * 16 + 8
        else:
            xy = torch.rand((B, N, 2), generator=gen, device="cuda")
            xy = xy * torch.tensor([W + 40.0, H + 40.0], device="cuda") - 20.0
            edges = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [radius + 0.5, radius - 0.5],
                                  [W - side + radius + 0.5, H - side + radius + 0.5], [-3.0, H + 3.0]],
                                 device="cuda")
            xy[:, : len(edges)] = edges
        fn = getattr(kgather, wrapper)
        got = fn(img, xy, radius)
        ref = kgather.gather_patches_reference(img, xy, radius, side)
        torch.cuda.synchronize()
        if got.shape != (B, N, side, side) or got.dtype != torch.float32:
            raise AssertionError(f"{wrapper} {(B, H, W, N)}: {got.dtype} {tuple(got.shape)}")
        err = (got - ref).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"{wrapper} {(B, H, W, N, radius)}: kernel != plain (max err {err})")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = median_ms(lambda: fn(img, xy, radius), TIMED_ITERS, WARMUP_ITERS, flush)
        plain_ms = median_ms(lambda: kgather.gather_patches_reference(img, xy, radius, side),
                             PLAIN_ITERS, 1, flush)
        idx = kgather.window_index(xy, W, radius, side, *kgather.window_bounds(img, radius, side))
        flat = img.reshape(B, H * W)
        library_ms = median_ms(lambda: torch.gather(flat, 1, idx), TIMED_ITERS, WARMUP_ITERS, flush)
        # A pure copy, no arithmetic: the distinct source pixels the windows
        # cover read once (overlapping windows share them), 8 B of centre
        # per window, every window written once.
        n_read = unique_pixels(idx, H * W)
        nbytes = n_read * 4 + B * N * (8 + side * side * 4)
        b_ms, b_by = bound(nbytes, 0.0)
        log(f"  {wrapper} {(B, H, W)} N={N} r={radius}: exact=True ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f} "
            f"distinct_pixels_read={n_read} window_pixels={B * N * side * side}")
        if i == 0:
            report.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes, ops=0.0)
    return report


def check_learned(torch, synthetic, render_all, tracking, config_mod, seg_mod, select_keypoints) -> None:
    """The ViT-S/16 learned frontend and the segmenter on the card against
    the CPU, the same seeded weights on both (bounds in the docstring).
    A freshly seeded offset head's last conv is zero, which would make
    every sub-patch offset exactly 0; here it gets seeded non-zero weights
    so the comparison runs through the gathered windows, their
    standardisation, the head's convolutions and its masked softmax."""
    seq = synthetic.make_sequence(num_frames=2, scale=1.0)
    rgb = torch.from_numpy(render_all(seq)[0])
    x = tracking.normalize_rgb(rgb)
    cfg = config_mod.load_model_config(LEARNED_CONFIG)

    def seeded(dtype):
        m = config_mod.build_model(cfg, dtype=dtype, generator=torch.Generator().manual_seed(SEED)).eval()
        w = m.offset_head.conv3.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(SEED + 1))
                    / w[0].numel() ** 0.5)
        return m

    model, model_f32 = seeded(torch.bfloat16), seeded(torch.float32)
    seg = seg_mod.SemanticSegmenter(generator=torch.Generator().manual_seed(SEED)).eval()
    with torch.no_grad():
        cpu = model(x)
        cpu_f32 = model_f32(x)
        cpu_labels = seg_mod.predict_classes(seg(rgb, full_res=False))
        kp = select_keypoints(cpu.saliency, model.num_keypoints, model.nms_radius)
        off_cpu = model.refine_at(cpu.features, cpu.saliency, x, kp.xy) - kp.xy
        model_gpu, seg_gpu = copy.deepcopy(model).cuda(), copy.deepcopy(seg).cuda()
        gpu = model_gpu(x.cuda())
        gpu_labels = seg_mod.predict_classes(seg_gpu(rgb.cuda(), full_res=False)).cpu()
        kp_gpu = select_keypoints(gpu.saliency, model.num_keypoints, model.nms_radius)
        # The sub-patch refinement alone, on the CPU's inputs.
        off_gpu = model_gpu.refine_at(cpu.features.cuda(), cpu.saliency.cuda(), x.cuda(),
                                      kp.xy.cuda()) - kp.xy.cuda()
    torch.cuda.synchronize()
    ps = model.patch_size
    sal_err = (gpu.saliency.cpu() - cpu.saliency).abs().max().item()
    # Patch-centre selections, as sets per frame (exact patch coordinates).
    sel_cpu, sel_gpu = kp.xy, kp_gpu.xy.cpu()
    selected = float((torch.cdist(sel_cpu, sel_gpu).min(-1).values <= 1e-3).float().mean())
    # Sub-patch offsets on the same inputs, in pixels.
    d_off = ((off_gpu.cpu() - off_cpu) * ps).abs().amax(-1)
    off_same = float((d_off <= 1e-3).float().mean())
    off_mean = float((off_cpu * ps).abs().mean())

    # Distance from each CPU keypoint to the nearest card (or f32) one.
    dist, j = torch.cdist(cpu.keypoints_px, gpu.keypoints_px.cpu()).min(-1)
    dist_f32 = torch.cdist(cpu.keypoints_px, cpu_f32.keypoints_px).min(-1).values
    within = {t: float((dist <= t).float().mean()) for t in (0.05, 0.5)}
    within_f32 = {t: float((dist_f32 <= t).float().mean()) for t in (0.05, 0.5)}
    pair = dist <= 0.05
    desc_gpu = torch.gather(gpu.descriptors.cpu(), 1, j[..., None].expand(-1, -1, cpu.descriptors.shape[-1]))
    cos = (desc_gpu * cpu.descriptors).sum(-1)[pair]
    agree = float((gpu_labels == cpu_labels).float().mean())
    log(f"  learned card vs cpu: saliency max abs diff {sal_err:.3g} (bound 0.02); patch-centre "
        f"keypoints selected by both {selected:.4f} (bound 0.90); sub-patch offsets on the same "
        f"inputs: mean |offset| {off_mean:.3f} px (bound >= 0.5), within 1e-3 px {off_same:.4f} "
        f"(bound 0.99), max |diff| {d_off.max().item():.3g} px; refined keypoints within 0.05 / 0.5 px "
        f"{within[0.05]:.4f} / {within[0.5]:.4f} (bound 0.90 at 0.5 px; bf16 vs f32 on the cpu "
        f"{within_f32[0.05]:.4f} / {within_f32[0.5]:.4f}); descriptor cosine over {int(pair.sum())} "
        f"pairs within 0.05 px mean {float(cos.mean()):.5f} min {float(cos.min()):.5f} "
        f"(bounds 0.99 / 0.9); segmenter labels agree {agree:.5f} (bound 0.99)")
    if not (sal_err <= 0.02 and selected >= 0.90 and off_mean >= 0.5 and off_same >= 0.99
            and within[0.5] >= 0.90 and int(pair.sum()) > 0 and float(cos.mean()) >= 0.99
            and float(cos.min()) >= 0.9 and agree >= 0.99):
        raise AssertionError("learned frontend or segmenter on the card disagrees with the CPU")


def learned_split(torch, synthetic, render_all, tracking, run_slam_cli, select_keypoints) -> dict:
    """Device ms per 8-frame chunk of each stage of the learned path
    (segmenter, backbone, saliency head + selection, sub-patch refinement,
    descriptors), warm, median of 5, with the path's seeded models."""
    args = argparse.Namespace(
        seed=SEED, train_config=LEARNED_CONFIG, checkpoint=None, segmenter_checkpoint=None)
    model = run_slam_cli.load_learned_frontend(args, torch.device("cuda"))
    seg = run_slam_cli.load_segmenter(args, torch.device("cuda"))
    seq = synthetic.make_sequence(num_frames=run_slam_cli.LEARNED_CHUNK, scale=1.0)
    rgb = torch.from_numpy(render_all(seq)[0]).cuda()
    x = tracking.normalize_rgb(rgb)
    out = {}
    with torch.no_grad():
        feats = model.backbone(x)
        sal = model.selector(feats)
        kp = select_keypoints(sal, model.num_keypoints, model.nms_radius)
        xy = model.refine_at(feats, sal, x, kp.xy)
        stages = {
            "segmenter": lambda: seg(rgb, full_res=False),
            "backbone": lambda: model.backbone(x),
            "saliency_select": lambda: select_keypoints(model.selector(feats), model.num_keypoints,
                                                        model.nms_radius),
            "subpatch_refine": lambda: model.refine_at(feats, sal, x, kp.xy),
            "describe": lambda: model.describe_at(feats, xy),
        }
        for name, fn in stages.items():
            for _ in range(2):
                fn()
            times = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            out[name] = sorted(times)[2]
    return out


def run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, argv) -> tuple:
    """``run-slam`` then ``evaluate`` in ``tmp``: (run stats, evaluation)."""
    t0 = time.perf_counter()
    run_slam_cli.main(argv + ["--device", "cuda", "--seed", str(SEED), "--output-dir", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evaluate_cli.main(["--trajectories", tmp])
    with open(os.path.join(tmp, "results.json")) as f:
        (name, res), = json.load(f).items()
    with open(os.path.join(tmp, f"{name}_run.json")) as f:
        run = json.load(f)
    if res.get("status") != "success":
        raise AssertionError(f"evaluate failed: {res}")
    run["wall_s"] = wall
    return run, res


def check_frontend(torch, tracking, synthetic, seg_mod) -> None:
    """The card's frontend (both kernels) against the CPU's (their plain
    versions) on two 640x480 frames, and on two frames of the dynamic
    world with the GT class-weight map (``weight_map``: it scales the
    corner scores and sets each keypoint's ``sem_weight``). The
    pyramid's resize products sum in another order on the card, which
    moves sub-pixel refinements by ~1e-4 px; a keypoint coincides when
    its slot holds the same detection within 1e-3 px. >= 98% must
    coincide, >= 99% of their descriptors must be bit-identical (an ulp
    in a blurred pixel can cross a quantisation step), and their
    ``sem_weight`` must be equal. With the weight map, some keypoints must
    carry a weight below 1 and the detections must differ from the
    unweighted ones on the same frames."""
    from semantic_slam_master_tpu_torch.cli.run_slam_cli import render_all

    static = synthetic.make_sequence(num_frames=2, scale=1.0)
    dynamic = synthetic.make_dynamic_sequence(num_frames=2, scale=1.0)
    for name, seq, weighted in (("static", static, False), ("dynamic + GT weight map", dynamic, True)):
        _, gray, depth, labels = render_all(seq)
        g, d = torch.from_numpy(gray), torch.from_numpy(depth)
        wmap = seg_mod.class_weights_map(torch.from_numpy(labels)) if weighted else None
        cpu = tracking.extract_features(g, d, weight_map=wmap)
        gpu = tracking.extract_features(g.cuda(), d.cuda(),
                                        weight_map=None if wmap is None else wmap.cuda())
        torch.cuda.synchronize()
        gpu = tracking.FrameFeatures(*[x.cpu() for x in gpu])
        coincide = ((gpu.xy - cpu.xy).abs().amax(-1) <= 1e-3) & (gpu.valid == cpu.valid)
        share = float(coincide[cpu.valid].float().mean())
        exact_xy = float((gpu.xy == cpu.xy).all(-1)[cpu.valid].float().mean())
        same_desc = float((gpu.desc == cpu.desc).all(-1)[coincide & cpu.valid].float().mean())
        same_w = bool((gpu.sem_weight == cpu.sem_weight)[coincide & cpu.valid].all())
        log(f"  frontend card vs cpu, {name}: keypoints coincide {share:.4f} (bit-identical xy "
            f"{exact_xy:.4f}), descriptors identical where they coincide {same_desc:.4f}, "
            f"sem_weight equal {same_w}, valid {int(gpu.valid.sum())}/{gpu.valid.numel()}")
        if share < 0.98 or same_desc < 0.99 or not same_w:
            raise AssertionError(f"frontend on the card disagrees with the CPU frontend ({name})")
        if weighted:
            plain = tracking.extract_features(g.cuda(), d.cuda())
            torch.cuda.synchronize()
            down = int((gpu.sem_weight < 1.0)[gpu.valid].sum())
            moved = float(((plain.xy.cpu() - gpu.xy).abs().amax(-1) > 1e-3)[gpu.valid].float().mean())
            log(f"  weight map on the card: {down} keypoints weighted below 1, "
                f"{moved:.4f} of the slots hold another keypoint than without the map")
            if down == 0 or moved == 0.0:
                raise AssertionError("the weight map changed nothing on the card")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli
    from semantic_slam_master_tpu_torch.data import synthetic
    from semantic_slam_master_tpu_torch.models import segmenter as seg_mod
    from semantic_slam_master_tpu_torch.models.selector import select_keypoints
    from semantic_slam_master_tpu_torch.ops.kernels import build
    from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
    from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch
    from semantic_slam_master_tpu_torch.slam import tracking
    from semantic_slam_master_tpu_torch.train import config as config_mod

    counters = {"fast_score": kfast.fast_score, "gather_aligned_patches": kpatch.gather_aligned_patches,
                "gather_patches": kgather.gather_patches}

    def reset_counts():
        for c in (*counters.values(), kgather.gather_patches_padded):
            c.launches = 0

    def read_counts():
        return {name: c.launches for name, c in counters.items()}

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        log(smi[0])
        kind = torch.cuda.get_device_name(0)
        log(f"  torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
            f"count {torch.cuda.device_count()} pyyaml "
            f"{'present' if importlib.util.find_spec('yaml') else 'absent'}")

    with phase("build"):
        secs = build.build(force=True)
        build.library()
        log(f"  nvcc built {build.LIB_PATH.name} from {len(build.sources())} sources "
            f"in {secs:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    with phase("fast_score vs plain"):
        fast = check_fast(torch, kfast, gen, flush)
    with phase("gather_aligned_patches vs plain"):
        patches = check_patches(torch, kpatch, gen, flush)
    with phase("gather_patches vs plain"):
        gather = check_gather(torch, kgather, gen, flush)
    del flush
    with phase("ORB frontend card vs cpu"):
        check_frontend(torch, tracking, synthetic, seg_mod)

    launches = {}
    with phase("ORB main path: run-slam --synthetic + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp,
                                ["--synthetic", "--synthetic-frames", str(MAIN_FRAMES)])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        log(f"  frames={MAIN_FRAMES} (not cut) run_slam_wall_s={run['wall_s']:.2f} ate_rmse_m={ate:.5f} "
            f"rpe_trans_rmse_m={res.get('rpe', {}).get('translation', {}).get('rmse')} "
            f"launches={counts} frontend_chunks={chunks} run={run}")
        if not (ate == ate and ate < 0.05):
            raise AssertionError(f"ATE {ate} is not finite and below 0.05 m")
        for name in ("fast_score", "gather_aligned_patches"):
            if counts[name] < 4 * chunks:
                raise AssertionError(f"{name} launched {counts[name]} times, expected >= {4 * chunks}")
            launches[name] = counts[name]

    with phase("learned frontend + segmenter card vs cpu"):
        check_learned(torch, synthetic, run_slam_cli.render_all, tracking, config_mod, seg_mod,
                      select_keypoints)

    with phase("learned path: run-slam --frontend learned --semantics model + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--frontend", "learned",
            "--train-config", LEARNED_CONFIG, "--semantics", "model"])
        counts = read_counts()
        chunks = -(-MAIN_FRAMES // run_slam_cli.LEARNED_CHUNK)
        log(f"  frames={MAIN_FRAMES} ViT-S/16 (seeded weights) run_slam_wall_s={run['wall_s']:.2f} "
            f"fps={run['fps']} segmenter_s={run['segmenter_s']} frontend_s={run['frontend_s']} "
            f"slam_loop_s={run['backend_s']} model_load_s={run['model_load_s']} "
            f"render_s={run['render_s']} keyframes={run['keyframes']} "
            f"mean_inliers={run['mean_inliers']:.1f} ate_rmse_m={res['ate']['rmse']:.5f} (not bounded) "
            f"launches={counts} learned_chunks={chunks}")
        if not run["finite_poses"]:
            raise AssertionError("the learned path gave non-finite poses")
        if counts["gather_patches"] < chunks:
            raise AssertionError(f"gather_patches launched {counts['gather_patches']} times, "
                                 f"expected >= {chunks}")
        launches["gather_patches"] = counts["gather_patches"]
        split = learned_split(torch, synthetic, run_slam_cli.render_all, tracking, run_slam_cli,
                              select_keypoints)
        log("  learned path, device ms per 8-frame chunk (warm): "
            + " ".join(f"{k}={v:.3f}" for k, v in split.items())
            + f"; SLAM loop {1e3 * run['backend_s'] / MAIN_FRAMES:.2f} ms/frame (cold, host clock)")

    with phase("dynamic path: run-slam --dynamic --semantics gt + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        reset_counts()
        run, res = run_cli_path(torch, run_slam_cli, evaluate_cli, tmp, [
            "--synthetic", "--synthetic-frames", str(MAIN_FRAMES), "--dynamic", "--semantics", "gt"])
        counts = read_counts()
        ate = res["ate"]["rmse"]
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        log(f"  frames={MAIN_FRAMES} run_slam_wall_s={run['wall_s']:.2f} fps={run['fps']} "
            f"ate_rmse_m={ate:.5f} (bound {DYNAMIC_ATE_BOUND_M}) keyframes={run['keyframes']} "
            f"launches={counts}")
        if not (ate == ate and ate < DYNAMIC_ATE_BOUND_M):
            raise AssertionError(f"dynamic ATE {ate} is not finite and below {DYNAMIC_ATE_BOUND_M} m")
        for name in ("fast_score", "gather_aligned_patches"):
            if counts[name] < 4 * chunks:
                raise AssertionError(f"{name} launched {counts[name]} times on the dynamic path")

    kernels = []
    for name, src, replaces, r, timed_as in (
        ("fast_score", "semantic_slam_master_tpu_torch/csrc/fast_score.cu",
         "semantic_slam_master_tpu/ops/pallas/fast_score.py:102", fast,
         "sum of the four pyramid levels of one 16-frame frontend chunk"),
        ("gather_aligned_patches", "semantic_slam_master_tpu_torch/csrc/aligned_patches.cu",
         "semantic_slam_master_tpu/ops/pallas/patches.py:206", patches,
         "sum of the four pyramid levels of one 16-frame frontend chunk; library_ms is one "
         "torch.gather over the precomputed index, the gather alone (no quantisation, f32 out)"),
        ("gather_patches", "semantic_slam_master_tpu_torch/csrc/gather_patches.cu",
         "semantic_slam_master_tpu/ops/pallas/patches.py:64", gather,
         "one 8-frame learned chunk: 8x500 windows of 21x21 from 480x640; library_ms is one "
         "torch.gather over the precomputed index, the gather alone"),
    ):
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"), "status": "checked", "timed_as": timed_as,
        })
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke total {time.perf_counter() - T_START:.2f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
