"""Segmenter training on the synthetic world, whose labels come free (port
of ``train/seg_trainer.py``): rendered (rgb, labels) batches, pixel
cross-entropy, AdamW on a cosine decay (``train.optim``), and ``.npz``
checkpoints keyed by flax path that ``run-slam --semantics model
--segmenter-checkpoint`` reads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .. import convert
from ..core.device import resolve_device
from ..models import segmenter as seg_mod
from .optim import AdamW, cosine_decay_schedule

WEIGHT_DECAY = 1e-4


def synthetic_label_batches(batch_size: int, image_hw: Tuple[int, int] = (120, 160), seed: int = 0,
                            num_frames: int = 64, dynamic: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Endless (rgb, labels) batches from two synthetic worlds (seeds
    ``seed`` and ``seed + 1``), rendered once and cycled with random picks,
    horizontal flips and a brightness / colour jitter -- the JAX builder's
    arrays, bit for bit."""
    from ..core.camera import TUM_FR2
    from ..data import synthetic

    h, w = image_hw
    cam = TUM_FR2.scaled(w / TUM_FR2.width, h / TUM_FR2.height)
    make = synthetic.make_dynamic_sequence if dynamic else synthetic.make_sequence
    rng = np.random.default_rng(seed)
    frames = []
    for s in (seed, seed + 1):
        seq = make(num_frames=num_frames // 2, cam=cam, seed=s)
        for i in range(len(seq)):
            f = seq.frame(i)
            frames.append((f["rgb"], f["labels"]))
    while True:
        idx = rng.integers(0, len(frames), size=batch_size)
        rgb = np.stack([frames[i][0] for i in idx])
        lab = np.stack([frames[i][1] for i in idx])
        flip = rng.random(batch_size) < 0.5
        rgb[flip] = rgb[flip, :, ::-1]
        lab[flip] = lab[flip, :, ::-1]
        gain = rng.uniform(0.7, 1.3, size=(batch_size, 1, 1, 3)).astype(np.float32)
        bias = rng.uniform(-0.08, 0.08, size=(batch_size, 1, 1, 3)).astype(np.float32)
        rgb = np.clip(rgb * gain + bias, 0.0, 1.0)
        yield {"rgb": rgb.astype(np.float32), "labels": lab.astype(np.int32)}


def make_optimizer(lr: float, num_steps: int) -> AdamW:
    """``optax.adamw(optax.cosine_decay_schedule(lr, num_steps), 1e-4)``."""
    return AdamW(cosine_decay_schedule(lr, num_steps), WEIGHT_DECAY)


def make_train_step(model: seg_mod.SemanticSegmenter, tx: AdamW):
    """``step(opt_state, batch) -> (opt_state, {"loss", "accuracy"})`` on
    device tensors; the model's parameters are updated in place."""
    params = dict(model.named_parameters())

    def step(opt_state, batch):
        with torch.enable_grad():
            logits = model(batch["rgb"])
            loss = seg_mod.segmentation_loss(logits, batch["labels"])
            grads = torch.autograd.grad(loss, list(params.values()))
        acc = torch.mean((torch.argmax(logits.detach(), dim=-1) == batch["labels"]).float())
        new_params, opt_state, _ = tx.update(dict(zip(params, grads)), opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return opt_state, {"loss": loss.detach(), "accuracy": acc}

    return step


def train(num_steps: int = 300, batch_size: int = 8, lr: float = 3e-3, image_hw: Tuple[int, int] = (120, 160),
          seed: int = 0, width: int = 32, log_every: int = 25, verbose: bool = True, device="cuda"):
    """Train the segmenter (weights drawn by PyTorch from ``seed``) on
    synthetic frames; returns (model, final metrics)."""
    device = resolve_device(device)
    model = seg_mod.SemanticSegmenter(width=width, generator=torch.Generator().manual_seed(seed)).to(device)
    tx = make_optimizer(lr, num_steps)
    opt_state = tx.init(dict(model.named_parameters()))
    step = make_train_step(model, tx)
    data = synthetic_label_batches(batch_size, image_hw, seed=seed)
    metrics = {}
    for i in range(num_steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        opt_state, metrics = step(opt_state, batch)
        if verbose and (i % log_every == 0 or i == num_steps - 1):
            print(f"step {i}: loss={float(metrics['loss']):.4f} acc={float(metrics['accuracy']):.3f}")
    return model, {k: float(v) for k, v in metrics.items()}


def save_checkpoint(path, model: seg_mod.SemanticSegmenter) -> Path:
    """Write the segmenter's params as ``.npz`` keyed by flax path."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **convert.segmenter_tree(model.state_dict()))
    return path


def load_checkpoint(path) -> dict:
    """The ``state_dict`` of a segmenter checkpoint (any width)."""
    return convert.segmenter_state_dict(path)
