"""``train`` -- the learned frontend's training CLI (port of the JAX
package's ``cli/train_cli.py``, same flags, plus ``--device``).

Loads a reference-compatible YAML config, builds frame-pair batches from
TUM sequences or the synthetic world (the JAX CLI's builders, copied:
for the same config and epoch they give the same arrays, bit for bit),
and runs ``train.trainer.fit`` with console / JSONL / wandb sinks and
best-checkpoint retention (``<save_dir>/best_model.npz``). Runs on the
card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _synthetic_pair_batches(cfg, split_seed: int, num_worlds: int | None = None):
    """Deterministic frame-pair batches from ``num_worlds`` seeded synthetic
    rooms rendered 1.3x oversized: each pair takes a random anisotropic
    crop resized to the square training shape (an intrinsics change), and
    frame 2's crop origin is jittered by up to 12 render pixels (so the
    localisation loss sees sub-patch phase differences). Batches carry
    depth1, K, K2 and rel_pose (T_2<-1) for the GT-warp terms."""
    from ..data import synthetic, tum as tum_mod

    if num_worlds is None:
        num_worlds = cfg.dataset.synthetic_worlds
    size = cfg.model.input_size
    render_scale = size / 480.0 * 1.3
    worlds = []
    for w in range(num_worlds):
        seq = synthetic.make_sequence(num_frames=cfg.dataset.synthetic_frames, scale=render_scale,
                                      seed=1000 * split_seed + w)
        frames = [seq.frame(i) for i in range(len(seq))]
        worlds.append({
            "rgb": np.stack([f["rgb"] for f in frames]),
            "depth": np.stack([f["depth"] for f in frames]),
            "poses": np.asarray(seq.poses_wc, np.float64),
            "cam": seq.cam,
        })
    H0, W0 = worlds[0]["depth"].shape[1:]
    inv = np.linalg.inv

    def crop_item(world, j, spacing, rng):
        ch = int(rng.integers(size, H0 + 1))
        cw = int(rng.integers(size, W0 + 1))
        oy = int(rng.integers(0, H0 - ch + 1))
        ox = int(rng.integers(0, W0 - cw + 1))
        jx = int(rng.integers(-12, 13))
        jy = int(rng.integers(-12, 13))
        ox2 = min(max(ox + jx, 0), W0 - cw)
        oy2 = min(max(oy + jy, 0), H0 - ch)
        r1 = tum_mod.resize_bilinear(world["rgb"][j, oy : oy + ch, ox : ox + cw], size, size)
        r2 = tum_mod.resize_bilinear(world["rgb"][j + spacing, oy2 : oy2 + ch, ox2 : ox2 + cw], size, size)
        d1 = tum_mod.resize_nearest(world["depth"][j, oy : oy + ch, ox : ox + cw], size, size)
        cam = world["cam"]
        sx, sy = size / cw, size / ch

        def _K(off_x, off_y):
            return np.array([
                [cam.fx * sx, 0.0, (cam.cx - off_x) * sx],
                [0.0, cam.fy * sy, (cam.cy - off_y) * sy],
                [0.0, 0.0, 1.0],
            ], np.float32)

        rel = (inv(world["poses"][j + spacing]) @ world["poses"][j]).astype(np.float32)
        return (
            tum_mod.imagenet_normalize(r1).astype(np.float32),
            tum_mod.imagenet_normalize(r2).astype(np.float32),
            d1.astype(np.float32),
            _K(ox, oy),
            _K(ox2, oy2),
            rel,
        )

    def batches(epoch=0):
        rng = np.random.default_rng(1000 * split_seed + epoch)
        spacing = cfg.dataset.frame_spacing
        F = cfg.dataset.synthetic_frames
        pairs = [(w, j) for w in range(num_worlds) for j in range(F - spacing)]
        rng.shuffle(pairs)
        b = cfg.training.batch_size
        for start in range(0, len(pairs) - b + 1, b):
            items = [crop_item(worlds[w], j, spacing, rng) for w, j in pairs[start : start + b]]
            r1, r2, d1, K, K2, rel = map(np.stack, zip(*items))
            yield {"rgb1": r1, "rgb2": r2, "depth1": d1, "K": K, "K2": K2, "rel_pose": rel}

    return batches


def _tum_pair_batches(cfg, sequences, is_train: bool):
    """Frame-pair batches (rgb1, rgb2) from TUM sequences on disk, shuffled
    and augmented for training, in order and plain for validation."""
    from ..data.tum import AugmentationConfig, TUMSequence, batch_pairs

    aug_cfg = cfg.dataset.augmentation
    aug = AugmentationConfig(
        enabled=aug_cfg.enabled, brightness=aug_cfg.brightness, contrast=aug_cfg.contrast,
        saturation=aug_cfg.saturation, hue=aug_cfg.hue, gaussian_blur=aug_cfg.gaussian_blur,
    ) if is_train else None
    datasets = []
    for name in sequences:
        try:
            datasets.append(TUMSequence(cfg.dataset.root, name, input_size=cfg.model.input_size,
                                        frame_spacing=cfg.dataset.frame_spacing, max_frames=cfg.dataset.max_frames,
                                        augmentation=aug))
        except FileNotFoundError as e:
            print(f"[train] skipping {name}: {e}", file=sys.stderr)
    if not datasets:
        raise FileNotFoundError("no TUM sequences available")
    index = [(d, i) for d in datasets for i in range(len(d))]

    def batches(epoch=0):
        rng = np.random.default_rng(epoch if is_train else 12345)
        order = np.arange(len(index))
        if is_train:
            rng.shuffle(order)
        b = cfg.training.batch_size
        for start in range(0, len(order) - b + 1, b):
            pairs = []
            for k in order[start : start + b]:
                d, i = index[k]
                seed = int(rng.integers(0, 2**31)) if is_train else None
                pairs.append(d.pair(i, seed=seed))
            batch = batch_pairs(pairs)
            yield {"rgb1": batch["rgb1"], "rgb2": batch["rgb2"]}

    return batches


def main(argv=None):
    parser = argparse.ArgumentParser(prog="train", description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None,
                        help="steps per epoch of the LR schedule (default: the config's, else 16)")
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--jsonl-log", default=None)
    parser.add_argument("--init-from", default=None,
                        help="checkpoint (.npz) to warm-start weights from (fresh optimizer/schedule)")
    parser.add_argument("--resume", default=None,
                        help="full-state checkpoint (.npz) to resume from (optimizer state, PRNG key and "
                        "LR schedule continue; epochs pick up at meta epoch + 1)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from ..core.device import resolve_device
    from ..train import config as config_mod, trainer
    from ..utils import sinks

    device = resolve_device(args.device)
    cfg = config_mod.load_config(args.config)
    if args.synthetic:
        cfg.dataset.synthetic = True
    if args.epochs:
        cfg.training.epochs = args.epochs
    if args.save_dir:
        cfg.training.save_dir = args.save_dir

    if cfg.dataset.synthetic:
        train_batches = _synthetic_pair_batches(cfg, split_seed=0)
        val_batches_fn = _synthetic_pair_batches(cfg, split_seed=1)
        val_batches = lambda: val_batches_fn(0)  # noqa: E731
    else:
        train_batches = _tum_pair_batches(cfg, cfg.dataset.train_sequences, True)
        val_fn = _tum_pair_batches(cfg, cfg.dataset.val_sequences, False)
        val_batches = lambda: val_fn(0)  # noqa: E731

    sink_list = [sinks.ConsoleSink()]
    if args.jsonl_log:
        sink_list.append(sinks.JsonlSink(args.jsonl_log))
    if cfg.logging.use_wandb:
        sink_list.append(sinks.WandbSink(cfg.logging.project, cfg.logging.run_name, config_mod.to_dict(cfg)))
    sink = sinks.MultiSink(sink_list)

    steps = args.steps_per_epoch or cfg.training.steps_per_epoch or 16
    try:
        trainer.fit(cfg, train_batches, val_batches, steps_per_epoch=steps, log_fn=sink.log,
                    init_from=args.init_from, resume_from=args.resume, device=device)
    finally:
        sink.close()
    print(f"done; best checkpoint in {Path(cfg.training.save_dir) / 'best_model.npz'}")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
