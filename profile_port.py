#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

    python3 profile_port.py [--frames 24] [--seed 0]
    python3 profile_port.py --frontend learned --semantics model
    python3 profile_port.py --old-tree DIR [--frontend learned]

Renders the synthetic sequence at 640x480, then runs the port's frontend
(ORB in 16-frame chunks, or the learned ViT-S/16 frontend of
``--train-config`` in 8-frame chunks, with seeded weights, after the
segmenter with ``--semantics model``) and its SLAM loop once untraced
(warm-up and wall times) and once under ``torch.profiler``; with the
learned frontend it also traces its sub-patch refinement stage alone
(``refine_at`` on one 8-frame chunk, warm). Prints the card's name and
power limit, the wall time of each stage, the device's busy time (the
union of its kernel intervals) and idle share over the traced window,
and the operators with the most device and host time. Needs CUDA.

``--old-tree DIR`` compares the stages of an older checkout's port (DIR
holds its ``semantic_slam_master_tpu_torch/``) with this one's instead:
one process per tree in turns (old, new, new, old, twice),
each timing its warm stages with no profiler running (the frontend, and
with the learned frontend its sub-patch refinement alone: the median
wall time of repeated calls, host and device synchronised) and counting
the device kernels of one profiled call; prints each turn and the
medians. ``--tree DIR`` makes one such process import the port from DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPEATS = 20  # timed calls of each stage in a --tree process


def busy_ms(events) -> float:
    """Union of the device-kernel intervals of a profiler trace, in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start
    )
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frontend", choices=("orb", "learned"), default="orb")
    parser.add_argument("--semantics", choices=("off", "model"), default="off")
    parser.add_argument("--train-config", default="configs/train_vits_synthetic_long.yaml")
    parser.add_argument("--old-tree", help="compare with the port of this older checkout, in turns")
    parser.add_argument("--tree", help="import the port from this checkout and only time its stages")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
    if args.old_tree:
        return compare_trees(args)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from torch.profiler import ProfilerActivity, profile

    from semantic_slam_master_tpu_torch.cli import run_slam_cli as cli
    from semantic_slam_master_tpu_torch.core import prng
    from semantic_slam_master_tpu_torch.data import synthetic
    from semantic_slam_master_tpu_torch.slam import system

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    seq = synthetic.make_sequence(num_frames=args.frames, scale=1.0)
    rgb, gray, depth, _ = cli.render_all(seq)
    cfg = system.SlamConfig()
    # The run-slam CLI's RANSAC draws: JAX's own for --seed.
    uniforms = torch.from_numpy(prng.slam_uniforms(args.seed, args.frames, cfg.num_hypotheses)).to(dev)
    load_args = argparse.Namespace(seed=args.seed, train_config=args.train_config, checkpoint=None,
                                   segmenter_checkpoint=None)
    segmenter = cli.load_segmenter(load_args, dev) if args.semantics == "model" else None
    model = cli.load_learned_frontend(load_args, dev) if args.frontend == "learned" else None

    def frontend():
        wmap = cli.semantic_weight_maps(rgb, None, args.semantics, dev, segmenter)
        if model is not None:
            return cli.learned_features_for_frames(model, rgb, depth, dev, weight_map=wmap)
        return cli.features_for_frames(gray, depth, 512, dev, weight_map=wmap)

    def stages():
        t0 = time.perf_counter()
        feats = frontend()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = system.run_slam(uniforms, feats, seq.cam, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, int(out.is_keyframe.sum())

    stages()  # warm-up: kernel build, cuBLAS/cuSOLVER handles, allocator
    fe_ms, be_ms, kfs = stages()
    print(f"untraced: frontend={args.frontend} semantics={args.semantics} frames={args.frames} frontend_ms={fe_ms:.1f} backend_ms={be_ms:.1f} "
          f"backend_ms_per_frame={be_ms / (args.frames - 1):.2f} keyframes={kfs}", flush=True)

    if args.tree:
        return time_stages(args, torch, frontend, refine_stage(args, torch, cli, model, rgb, dev))

    feats = frontend()
    traced = [("frontend", frontend), ("backend", lambda: system.run_slam(uniforms, feats, seq.cam, cfg))]
    refine = refine_stage(args, torch, cli, model, rgb, dev)
    if refine is not None:
        refine()
        traced.append(("subpatch_refine, one 8-frame chunk", refine))
    for name, fn in traced:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        busy = busy_ms(events)
        n_kernels = sum(1 for e in events if e.device_type.name == "CUDA")
        print(f"traced {name}: wall_ms={wall:.1f} device_busy_ms={busy:.1f} "
              f"idle_share={1 - busy / wall:.3f} device_kernels={n_kernels}", flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12), flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12), flush=True)
    return 0


def refine_stage(args, torch, cli, model, rgb, dev):
    """The learned frontend's sub-patch refinement on one 8-frame chunk, as
    a call (None with the ORB frontend)."""
    if model is None:
        return None
    from semantic_slam_master_tpu_torch.models.selector import select_keypoints
    from semantic_slam_master_tpu_torch.slam import tracking

    x = tracking.normalize_rgb(torch.from_numpy(rgb[:cli.LEARNED_CHUNK]).to(dev))
    with torch.no_grad():
        grid = model.backbone(x)
        sal = model.selector(grid)
        kp = select_keypoints(sal, model.num_keypoints, model.nms_radius)

    def refine():
        with torch.no_grad():
            return model.refine_at(grid, sal, x, kp.xy)

    return refine


def time_stages(args, torch, frontend, refine) -> int:
    """Median warm wall time (ms) of each stage over REPEATS calls (a
    quarter of them for the whole frontend), and the device kernels of one
    profiled call; one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    out = {"tree": args.tree, "frontend": args.frontend}
    for name, fn in (("frontend", frontend), ("subpatch_refine", refine)):
        if fn is None:
            continue
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPEATS if name != "frontend" else REPEATS // 4):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
        out[name] = {"ms": statistics.median(times), "min_ms": min(times), "device_kernels": kernels}
    print(json.dumps(out), flush=True)
    return 0


def compare_trees(args) -> int:
    """One ``--tree`` process per checkout in turns: old, new, new, old."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"old": os.path.abspath(args.old_tree), "new": here}
    runs = {"old": [], "new": []}
    for _ in range(2):
        for label in ("old", "new", "new", "old"):
            cmd = [sys.executable, os.path.join(here, "profile_port.py"), "--tree", trees[label],
                   "--frontend", args.frontend, "--semantics", args.semantics, "--frames", str(args.frames),
                   "--seed", str(args.seed), "--train-config", args.train_config]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(f"{label} tree failed ({proc.returncode}):\n{proc.stderr[-4000:]}", file=sys.stderr)
                return 1
            lines = proc.stdout.strip().splitlines()
            if len(runs["old"]) + len(runs["new"]) == 0:
                print(lines[0], flush=True)  # the card's name and power limit
            runs[label].append(json.loads(lines[-1]))
            print(f"{label}: {lines[-1]}", flush=True)
    for name in ("frontend", "subpatch_refine"):
        if name not in runs["new"][0]:
            continue
        med = {k: statistics.median(r[name]["ms"] for r in v) for k, v in runs.items()}
        kern = {k: v[0][name]["device_kernels"] for k, v in runs.items()}
        print(f"{name} ({args.frontend}): old_ms={med['old']:.4f} new_ms={med['new']:.4f} "
              f"new/old={med['new'] / med['old']:.4f} device_kernels old={kern['old']} new={kern['new']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
