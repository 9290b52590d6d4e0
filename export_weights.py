#!/usr/bin/env python3
"""Export the committed trained checkpoints as ``.npz`` files the PyTorch
port reads without JAX.

    JAX_PLATFORMS=cpu python3 export_weights.py [--out-dir weights]

Restores, through the JAX package on the CPU:

- ``artifacts/segmenter/best_model`` with ``seg_trainer.load_checkpoint``;
- ``artifacts/frontend_tiny/best_model`` (``configs/train_tiny_synthetic.yaml``)
  with ``trainer.create_train_state`` and ``trainer.restore_checkpoint``;

and writes their ``params`` and ``batch_stats`` (no optimizer state, PRNG
key or step), float32 as restored, through the port's ``convert.save_npz``
to ``<out-dir>/segmenter.npz`` and ``<out-dir>/frontend_tiny.npz``. The
port loads them with ``run-slam --segmenter-checkpoint`` and
``--checkpoint``. It also writes the tiny frontend's whole training state
(``convert.train_state_tree``: params, batch_stats, Adam's moments, both
optimiser counts, step and the PRNG key) to
``<out-dir>/frontend_tiny_state.npz``, with the checkpoint's meta (epoch,
val_loss) in ``frontend_tiny_state.meta.json``: the port's ``train
--resume`` reads it. This is the one script outside the tests that imports
both packages; it needs JAX, flax and orbax, which the card's machine
does not have, so the files are committed.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from semantic_slam_master_tpu.train import config as jconfig  # noqa: E402
from semantic_slam_master_tpu.train import seg_trainer, trainer  # noqa: E402
from semantic_slam_master_tpu_torch import convert  # noqa: E402

REPO = Path(__file__).resolve().parent
SEGMENTER = REPO / "artifacts" / "segmenter" / "best_model"
FRONTEND_TINY = REPO / "artifacts" / "frontend_tiny" / "best_model"
TINY_CONFIG = REPO / "configs" / "train_tiny_synthetic.yaml"


def segmenter_variables() -> dict:
    """The trained segmenter's ``{"params": ...}`` as numpy arrays."""
    return {"params": jax.device_get(seg_trainer.load_checkpoint(str(SEGMENTER)))}


def frontend_tiny_state():
    """The trained tiny frontend's restored ``TrainState`` and its meta."""
    cfg = jconfig.load_config(str(TINY_CONFIG))
    _, state = trainer.create_train_state(cfg, steps_per_epoch=1)
    state, meta = trainer.restore_checkpoint(str(FRONTEND_TINY), state)
    return jax.device_get(state), meta


def frontend_tiny_variables(state=None) -> dict:
    """The trained tiny frontend's ``{"params", "batch_stats"}``."""
    state = frontend_tiny_state()[0] if state is None else state
    return {"params": trainer.merge_params(state.trainable, state.frozen), "batch_stats": state.batch_stats}


def export(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    state, meta = frontend_tiny_state()
    for name, variables in (("segmenter", segmenter_variables()),
                            ("frontend_tiny", frontend_tiny_variables(state))):
        flat = convert.flatten_tree(variables)
        bad = {k: a.dtype for k, a in flat.items() if a.dtype != np.float32}
        if bad:
            raise TypeError(f"{name}: arrays that are not float32: {bad}")
        path = out_dir / f"{name}.npz"
        convert.save_npz(path, variables)
        written[name] = (path, len(flat), sum(a.nbytes for a in flat.values()))
    flat = convert.train_state_tree(state)
    path = out_dir / "frontend_tiny_state.npz"
    np.savez(path, **flat)
    (out_dir / "frontend_tiny_state.meta.json").write_text(json.dumps({**meta, "params_only": False}))
    written["frontend_tiny_state"] = (path, len(flat), sum(a.nbytes for a in flat.values()))
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out-dir", default=str(REPO / "weights"))
    args = parser.parse_args(argv)
    for name, (path, n, nbytes) in export(Path(args.out_dir)).items():
        print(f"{name}: {path} {n} arrays, {nbytes} bytes, "
              f"{path.stat().st_size} bytes on disk")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
