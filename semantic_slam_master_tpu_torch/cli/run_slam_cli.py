"""Synthetic-world SLAM -> TUM trajectory (port of ``run-slam --synthetic``
on the geometric ORB path: no semantics, no loop closing).

Renders the synthetic room, runs the ORB frontend in chunks of 16 frames
and the SLAM loop on ``--device`` (default ``cuda``), and writes
``<out>/<name>_trajectory.txt`` plus ``<name>_groundtruth.txt`` for
``evaluate``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..data import synthetic, trajectory_io
from ..slam import system, tracking

FRONTEND_CHUNK = 16


def features_for_frames(gray_np, depth_np, num_keypoints, device, chunk=FRONTEND_CHUNK):
    """Batched frontend over all frames in chunks of ``chunk`` frames (the
    last chunk padded by repeating its final frame), kept on ``device``."""
    n = len(gray_np)
    pad = (-n) % chunk
    if pad:
        gray_np = np.concatenate([gray_np, np.repeat(gray_np[-1:], pad, 0)])
        depth_np = np.concatenate([depth_np, np.repeat(depth_np[-1:], pad, 0)])
    outs = []
    for i in range(0, len(gray_np), chunk):
        g = torch.from_numpy(gray_np[i : i + chunk]).to(device)
        d = torch.from_numpy(depth_np[i : i + chunk]).to(device)
        outs.append(tracking.extract_features(g, d, num_keypoints=num_keypoints))
    return tracking.FrameFeatures(*[torch.cat(xs, dim=0)[:n] for xs in zip(*outs)])


def render(seq):
    """(gray, depth) float32 stacks of every frame of a synthetic sequence."""
    frames = [seq.frame(i) for i in range(len(seq))]
    rgb = np.stack([f["rgb"] for f in frames]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in frames]).astype(np.float32)
    return gray, depth


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sequence(seq, out_path: Path, args, device: torch.device) -> dict:
    t0 = time.perf_counter()
    gray_np, depth_np = render(seq)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    feats = features_for_frames(gray_np, depth_np, args.num_keypoints, device)
    _sync(device)
    t_frontend = time.perf_counter() - t0
    cfg = system.SlamConfig(
        num_landmarks=args.num_landmarks,
        window_size=args.window_size,
        ba_iters=args.ba_iters,
    )
    gen = torch.Generator().manual_seed(args.seed)
    t1 = time.perf_counter()
    out = system.run_slam(gen, feats, seq.cam, cfg)
    poses = out.poses_wc.cpu().numpy().astype(np.float64)
    t_slam = time.perf_counter() - t0
    t_backend = time.perf_counter() - t1

    out_path.parent.mkdir(parents=True, exist_ok=True)
    trajectory_io.write_tum_trajectory(out_path, seq.timestamps, poses)
    n = len(seq)
    return {
        "frames": n,
        "device": str(device),
        "render_s": round(t_render, 3),
        "frontend_s": round(t_frontend, 3),
        "backend_s": round(t_backend, 3),
        "slam_s": round(t_slam, 3),
        "fps": round(n / max(t_slam, 1e-9), 2),
        "keyframes": int(out.is_keyframe.sum()),
        "mean_inliers": float(out.num_inliers[1:].float().mean()) if n > 1 else 0.0,
        "trajectory": str(out_path),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="run-slam", description=__doc__)
    parser.add_argument("--synthetic", action="store_true", required=True,
                        help="run on the synthetic world (the only input this port reads yet)")
    parser.add_argument("--synthetic-frames", type=int, default=60)
    parser.add_argument("--synthetic-scale", type=float, default=1.0,
                        help="frame scale of the synthetic camera (1.0 = 640x480)")
    parser.add_argument("--output-dir", default="experiments/trajectories")
    parser.add_argument("--num-keypoints", type=int, default=512)
    parser.add_argument("--num-landmarks", type=int, default=2048)
    parser.add_argument("--window-size", type=int, default=5)
    parser.add_argument("--ba-iters", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    seq = synthetic.make_sequence(num_frames=args.synthetic_frames, scale=args.synthetic_scale)
    out_dir.mkdir(parents=True, exist_ok=True)
    trajectory_io.write_tum_trajectory(
        out_dir / f"{seq.name}_groundtruth.txt", seq.timestamps, seq.poses_wc
    )
    result = run_sequence(seq, out_dir / f"{seq.name}_trajectory.txt", args, device)
    print(f"{seq.name}: {result}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
