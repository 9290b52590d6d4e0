#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

    python3 profile_port.py [--frames 24] [--seed 0]
    python3 profile_port.py --frontend learned --semantics model

Renders the synthetic sequence at 640x480, then runs the port's frontend
(ORB in 16-frame chunks, or the learned ViT-S/16 frontend of
``--train-config`` in 8-frame chunks, with seeded weights, after the
segmenter with ``--semantics model``) and its SLAM loop once untraced
(warm-up and wall times) and once under ``torch.profiler``. Prints the card's name and
power limit, the wall time of each stage, the device's busy time (the
union of its kernel intervals) and idle share over the traced window,
and the operators with the most device and host time. Needs CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 1
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

    feats = frontend()
    for name, fn in (
        ("frontend", frontend),
        ("backend", lambda: system.run_slam(uniforms, feats, seq.cam, cfg)),
    ):
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


if __name__ == "__main__":
    sys.exit(main())
