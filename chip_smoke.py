#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its name and elapsed seconds (stdout flushed, the
device synchronised at the end of each):

1. device  -- CUDA present; the card's name and power limit (nvidia-smi).
2. build   -- nvcc builds semantic_slam_master_tpu_torch/csrc/*.cu.
3. fast_score / 4. gather_aligned_patches -- each kernel against its
   plain PyTorch version at the main path's shapes (FAST-9 decisions and
   patches exact, scores within 1e-6 relative), timed with CUDA events
   (median of 20 launches after warm-up, L2 flushed between launches,
   host enqueue time hidden behind a device spin)
   beside its bound and the plain version's time.
5. frontend -- extract_features on two 640x480 frames on the card against
   the same call on the CPU (the plain versions of both kernels).
6. main path -- ``run-slam --synthetic`` at 640x480 with the defaults
   (512 keypoints, 2048 landmarks, window 5, 4 BA iterations, 16-frame
   frontend chunks) on the card, then ``evaluate``; ATE must be finite
   and below 0.05 m, and both kernels must have been launched 4x per
   frontend chunk.

Then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``. Every failure raises, so the exit code
is non-zero and the last line is not printed.
"""

from __future__ import annotations

import contextlib
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
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0, "max_abs_err": 0.0}
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
        # Each keypoint: its 32x32 f32 window read once, 8 B of xy, a
        # 32x32 bf16 patch written.
        nbytes = B * N * (32 * 32 * 4 + 8 + 32 * 32 * 2)
        ops = B * N * 32 * 32 * PATCH_F32_OPS_PER_PIXEL
        b_ms, b_by = bound(nbytes, ops)
        log(f"  gather_aligned_patches {(B, H, W)} N={N}: exact=True ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f}")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bytes"] += nbytes
        total["ops"] += ops
        total["max_abs_err"] = max(total["max_abs_err"], err)
    return total


def check_frontend(torch, tracking, synthetic) -> None:
    """The card's frontend (both kernels) against the CPU's (their plain
    versions) on two 640x480 frames. The pyramid's resize products sum in
    another order on the card, which moves sub-pixel refinements by ~1e-4
    px; a keypoint coincides when its slot holds the same detection within
    1e-3 px. >= 98% must coincide, and >= 99% of their descriptors must be
    bit-identical (an ulp in a blurred pixel can cross a quantisation
    step)."""
    from semantic_slam_master_tpu_torch.cli.run_slam_cli import render

    seq = synthetic.make_sequence(num_frames=2, scale=1.0)
    gray, depth = render(seq)
    g, d = torch.from_numpy(gray), torch.from_numpy(depth)
    cpu = tracking.extract_features(g, d)
    gpu = tracking.extract_features(g.cuda(), d.cuda())
    torch.cuda.synchronize()
    gpu = tracking.FrameFeatures(*[x.cpu() for x in gpu])
    coincide = ((gpu.xy - cpu.xy).abs().amax(-1) <= 1e-3) & (gpu.valid == cpu.valid)
    share = float(coincide[cpu.valid].float().mean())
    exact_xy = float((gpu.xy == cpu.xy).all(-1)[cpu.valid].float().mean())
    same_desc = float((gpu.desc == cpu.desc).all(-1)[coincide & cpu.valid].float().mean())
    log(f"  frontend card vs cpu: keypoints coincide {share:.4f} (bit-identical xy "
        f"{exact_xy:.4f}), descriptors identical where they coincide {same_desc:.4f}, "
        f"valid {int(gpu.valid.sum())}/{gpu.valid.numel()}")
    if share < 0.98 or same_desc < 0.99:
        raise AssertionError("frontend on the card disagrees with the CPU frontend")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 1
    from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli
    from semantic_slam_master_tpu_torch.data import synthetic
    from semantic_slam_master_tpu_torch.ops.kernels import build
    from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch
    from semantic_slam_master_tpu_torch.slam import tracking

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        log(smi[0])
        kind = torch.cuda.get_device_name(0)
        log(f"  torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
            f"count {torch.cuda.device_count()}")

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
    del flush
    with phase("frontend card vs cpu"):
        check_frontend(torch, tracking, synthetic)

    with phase("main path: run-slam --synthetic + evaluate"), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kfast.fast_score.launches = 0
        kpatch.gather_aligned_patches.launches = 0
        t0 = time.perf_counter()
        run_slam_cli.main(["--synthetic", "--synthetic-frames", str(MAIN_FRAMES),
                           "--device", "cuda", "--seed", str(SEED), "--output-dir", tmp])
        torch.cuda.synchronize()
        launches = {"fast_score": kfast.fast_score.launches,
                    "gather_aligned_patches": kpatch.gather_aligned_patches.launches}
        wall = time.perf_counter() - t0
        evaluate_cli.main(["--trajectories", tmp])
        with open(os.path.join(tmp, "results.json")) as f:
            res = json.load(f)["synthetic_room"]
        if res.get("status") != "success":
            raise AssertionError(f"evaluate failed: {res}")
        ate = res["ate"]["rmse"]
        rpe = res.get("rpe", {}).get("translation", {}).get("rmse")
        chunks = -(-MAIN_FRAMES // run_slam_cli.FRONTEND_CHUNK)
        log(f"  frames={MAIN_FRAMES} (not cut) run_slam_wall_s={wall:.2f} "
            f"ate_rmse_m={ate:.5f} rpe_trans_rmse_m={rpe} launches={launches} "
            f"frontend_chunks={chunks}")
        if not (ate == ate and ate < 0.05):
            raise AssertionError(f"ATE {ate} is not finite and below 0.05 m")
        for name, n in launches.items():
            if n < 4 * chunks:
                raise AssertionError(f"{name} launched {n} times, expected >= {4 * chunks}")

    kernels = []
    for name, src, replaces, r in (
        ("fast_score", "semantic_slam_master_tpu_torch/csrc/fast_score.cu",
         "semantic_slam_master_tpu/ops/pallas/fast_score.py:102", fast),
        ("gather_aligned_patches", "semantic_slam_master_tpu_torch/csrc/aligned_patches.cu",
         "semantic_slam_master_tpu/ops/pallas/patches.py:206", patches),
    ):
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "status": "checked",
            "timed_as": "sum of the four pyramid levels of one 16-frame frontend chunk",
        })
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke total {time.perf_counter() - T_START:.2f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
