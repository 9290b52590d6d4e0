"""Synthetic-world SLAM -> TUM trajectory (port of ``run-slam
--synthetic``; no loop closing).

Renders the synthetic room (``--dynamic``: with a walking person),
optionally derives per-pixel semantic weights (``--semantics gt`` from
the world's labels, ``--semantics model`` from the segmenter's
1/4-resolution labels), runs the ORB frontend in chunks of 16 frames or
the learned frontend (``--frontend learned``) in chunks of 8, then the
SLAM loop, on ``--device`` (default ``cuda``), and writes
``<out>/<name>_trajectory.txt`` plus ``<name>_groundtruth.txt`` for
``evaluate``, and the run's stage times and counts as ``<name>_run.json``.

``--checkpoint`` and ``--segmenter-checkpoint`` take ``.npz`` files of
flax variables keyed by their flattened path (``convert.py``). Without
them the models get seeded weights and a warning, seeded by the JAX
CLI's rule (the segmenter from a fixed seed 0, the learned frontend from
the train config's ``training.seed``; ``--seed`` seeds neither), but
drawn by PyTorch's generator, so they are not JAX's numbers. ``--seed``
seeds the RANSAC draws, which are JAX's own for the same seed
(``core/prng.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..core import prng
from ..core.device import resolve_device
from ..data import synthetic, trajectory_io
from ..models import segmenter as seg_mod
from ..slam import system, tracking
from ..train import config as config_mod

FRONTEND_CHUNK = 16
LEARNED_CHUNK = 8
SEGMENTER_CHUNK = 8


def _pad_frames(arrays, chunk):
    """Pad each (F, ...) numpy array or tensor to a multiple of ``chunk``
    frames by repeating its last frame."""
    pad = (-len(arrays[0])) % chunk

    def padded(a):
        if a is None or not pad:
            return a
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
        return np.concatenate([a, np.repeat(a[-1:], pad, 0)])

    return [padded(a) for a in arrays]


def _chunk(a, i, chunk, device):
    """Frames [i, i + chunk) of a numpy array or tensor, on ``device``."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a[i : i + chunk].to(device)


def _cat_features(outs, n) -> tracking.FrameFeatures:
    return tracking.FrameFeatures(*[torch.cat(xs, dim=0)[:n] for xs in zip(*outs)])


def features_for_frames(gray_np, depth_np, num_keypoints, device, chunk=FRONTEND_CHUNK, weight_map=None):
    """Batched ORB frontend over all frames in chunks of ``chunk`` frames
    (the last chunk padded by repeating its final frame), kept on
    ``device``. ``weight_map`` is an optional (F, Hm, Wm) semantic weight."""
    n = len(gray_np)
    gray_np, depth_np, weight_map = _pad_frames([gray_np, depth_np, weight_map], chunk)
    outs = []
    for i in range(0, len(gray_np), chunk):
        outs.append(tracking.extract_features(
            _chunk(gray_np, i, chunk, device), _chunk(depth_np, i, chunk, device),
            num_keypoints=num_keypoints, weight_map=_chunk(weight_map, i, chunk, device),
        ))
    return _cat_features(outs, n)


def learned_features_for_frames(model, rgb_np, depth_np, device, chunk=LEARNED_CHUNK, weight_map=None):
    """Batched learned frontend over all frames in chunks of ``chunk``."""
    n = len(rgb_np)
    rgb_np, depth_np, weight_map = _pad_frames([rgb_np, depth_np, weight_map], chunk)
    outs = []
    for i in range(0, len(rgb_np), chunk):
        outs.append(tracking.extract_learned_features(
            model, _chunk(rgb_np, i, chunk, device), _chunk(depth_np, i, chunk, device),
            weight_map=_chunk(weight_map, i, chunk, device),
        ))
    return _cat_features(outs, n)


def render_all(seq):
    """(rgb, gray, depth, labels) float32 / int stacks of every frame."""
    frames = [seq.frame(i) for i in range(len(seq))]
    rgb = np.stack([f["rgb"] for f in frames]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in frames]).astype(np.float32)
    labels = np.stack([f["labels"] for f in frames]) if "labels" in frames[0] else None
    return rgb, gray, depth, labels


def render(seq):
    """(gray, depth) float32 stacks of every frame of a synthetic sequence."""
    _, gray, depth, _ = render_all(seq)
    return gray, depth


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warn(msg: str) -> None:
    print(f"[run-slam] {msg}", file=sys.stderr)


# The JAX CLI initialises an untrained segmenter from PRNGKey(0), whatever --seed is.
SEGMENTER_SEED = 0


def load_segmenter(args, device) -> seg_mod.SemanticSegmenter:
    gen = torch.Generator().manual_seed(SEGMENTER_SEED)
    model = seg_mod.SemanticSegmenter(generator=gen)
    if args.segmenter_checkpoint:
        model.load_state_dict(convert.segmenter_state_dict(args.segmenter_checkpoint))
    else:
        _warn(f"--semantics model without --segmenter-checkpoint: weights seeded from "
              f"{SEGMENTER_SEED} as the JAX CLI seeds them, but drawn by PyTorch, not JAX's "
              f"numbers (labels will be noise)")
    return model.to(device).eval()


def load_learned_frontend(args, device):
    """The ``LearnedFrontend`` of ``--train-config`` (default: the JAX
    package's ``ModelConfig``), with ``--checkpoint`` weights or ones seeded
    from the config's ``training.seed``, as the JAX trainer seeds them."""
    cfg = config_mod.load_model_config(args.train_config) if args.train_config else config_mod.ModelConfig()
    seed = config_mod.load_training_seed(args.train_config)
    model = config_mod.build_model(cfg, generator=torch.Generator().manual_seed(seed))
    if args.checkpoint:
        model.load_state_dict(convert.frontend_state_dict(args.checkpoint))
    else:
        _warn(f"--frontend learned without --checkpoint: weights seeded from training.seed {seed} "
              f"as the JAX trainer seeds them, but drawn by PyTorch, not JAX's numbers")
    return model.to(device).eval()


def semantic_weight_maps(rgb_np, labels_np, semantics, device, model=None):
    """(F, Hm, Wm) f32 residual weights on ``device``, or None: the GT
    labels' class weights (``gt``), or the 1/4-resolution labels of the
    segmenter ``model`` (``model``)."""
    if semantics == "off":
        return None
    if semantics == "gt":
        if labels_np is None:
            _warn("--semantics gt needs GT labels; skipping")
            return None
        return seg_mod.class_weights_map(torch.from_numpy(labels_np).to(device))
    labels = []
    with torch.no_grad():
        for i in range(0, len(rgb_np), SEGMENTER_CHUNK):
            logits = model(_chunk(rgb_np, i, SEGMENTER_CHUNK, device), full_res=False)
            labels.append(seg_mod.predict_classes(logits))
    return seg_mod.class_weights_map(torch.cat(labels, dim=0))


def run_sequence(seq, out_path: Path, args, device: torch.device) -> dict:
    t0 = time.perf_counter()
    rgb_np, gray_np, depth_np, labels_np = render_all(seq)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    segmenter = load_segmenter(args, device) if args.semantics == "model" else None
    frontend = load_learned_frontend(args, device) if args.frontend == "learned" else None
    _sync(device)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    weight_map = semantic_weight_maps(rgb_np, labels_np, args.semantics, device, segmenter)
    _sync(device)
    t_segmenter = time.perf_counter() - t0

    t0 = time.perf_counter()
    if frontend is not None:
        feats = learned_features_for_frames(frontend, rgb_np, depth_np, device, weight_map=weight_map)
    else:
        feats = features_for_frames(gray_np, depth_np, args.num_keypoints, device, weight_map=weight_map)
    _sync(device)
    t_frontend = time.perf_counter() - t0
    cfg = system.SlamConfig(
        num_landmarks=args.num_landmarks,
        window_size=args.window_size,
        ba_iters=args.ba_iters,
    )
    # The JAX run_slam's RANSAC draws for PRNGKey(--seed), so a run pairs
    # with the JAX package's run of the same seed.
    uniforms = torch.from_numpy(prng.slam_uniforms(args.seed, len(seq), cfg.num_hypotheses)).to(device)
    t1 = time.perf_counter()
    out = system.run_slam(uniforms, feats, seq.cam, cfg)
    poses = out.poses_wc.cpu().numpy().astype(np.float64)
    t_backend = time.perf_counter() - t1
    t_slam = t_segmenter + t_frontend + t_backend

    out_path.parent.mkdir(parents=True, exist_ok=True)
    trajectory_io.write_tum_trajectory(out_path, seq.timestamps, poses)
    n = len(seq)
    return {
        "frames": n,
        "device": str(device),
        "frontend": args.frontend,
        "semantics": args.semantics,
        "render_s": round(t_render, 3),
        "model_load_s": round(t_load, 3),
        "segmenter_s": round(t_segmenter, 3),
        "frontend_s": round(t_frontend, 3),
        "backend_s": round(t_backend, 3),
        "slam_s": round(t_slam, 3),
        "fps": round(n / max(t_slam, 1e-9), 2),
        "keyframes": int(out.is_keyframe.sum()),
        "mean_inliers": float(out.num_inliers[1:].float().mean()) if n > 1 else 0.0,
        "finite_poses": bool(np.isfinite(poses).all()),
        "trajectory": str(out_path),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="run-slam", description=__doc__)
    parser.add_argument("--synthetic", action="store_true", required=True,
                        help="run on the synthetic world (the only input this port reads yet)")
    parser.add_argument("--synthetic-frames", type=int, default=60)
    parser.add_argument("--synthetic-scale", type=float, default=1.0,
                        help="frame scale of the synthetic camera (1.0 = 640x480)")
    parser.add_argument("--dynamic", action="store_true",
                        help="synthetic world with a moving person slab")
    parser.add_argument("--semantics", choices=("off", "gt", "model"), default="off",
                        help="semantic residual weighting: GT labels or the SemanticSegmenter")
    parser.add_argument("--segmenter-checkpoint", default=None,
                        help=".npz of flax segmenter params for --semantics model (without it: "
                             "weights seeded from 0, as the JAX CLI does, drawn by PyTorch)")
    parser.add_argument("--frontend", choices=("orb", "learned"), default="orb",
                        help="classic ORB (Hamming) or the LearnedFrontend (cosine)")
    parser.add_argument("--train-config", default=None,
                        help="training YAML whose model: section sizes --frontend learned")
    parser.add_argument("--checkpoint", default=None,
                        help=".npz of flax LearnedFrontend variables for --frontend learned (without "
                             "it: weights seeded from the config's training.seed, drawn by PyTorch)")
    parser.add_argument("--output-dir", default="experiments/trajectories")
    parser.add_argument("--num-keypoints", type=int, default=512,
                        help="ORB keypoints per frame (the learned frontend takes its config's)")
    parser.add_argument("--num-landmarks", type=int, default=2048)
    parser.add_argument("--window-size", type=int, default=5)
    parser.add_argument("--ba-iters", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the RANSAC draws (JAX's own for the same seed); seeded "
                             "weights follow the JAX CLI's rule instead: see the description")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    make = synthetic.make_dynamic_sequence if args.dynamic else synthetic.make_sequence
    seq = make(num_frames=args.synthetic_frames, scale=args.synthetic_scale)
    out_dir.mkdir(parents=True, exist_ok=True)
    trajectory_io.write_tum_trajectory(
        out_dir / f"{seq.name}_groundtruth.txt", seq.timestamps, seq.poses_wc
    )
    result = run_sequence(seq, out_dir / f"{seq.name}_trajectory.txt", args, device)
    (out_dir / f"{seq.name}_run.json").write_text(json.dumps(result, indent=2))
    print(f"{seq.name}: {result}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
