#!/usr/bin/env python3
"""Where the card's run-to-run training gap comes from.

    python3 profile_determinism.py [--repeats 3] [--steps 2] [--json FILE]

Runs chip_smoke.py phase 22's train step on the card -- the derived
``init`` YAML (configs/train_tiny_synthetic.yaml, 17 frames of one world),
weights/frontend_tiny.npz as ``--init-from`` loads them, a fresh optimiser,
the first training batch -- ``--steps`` steps from the same start,
``--repeats`` times with PyTorch's default kernels and ``--repeats`` times
under ``torch.use_deterministic_algorithms(True)``
(``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set for both, before CUDA starts).
For each mode it prints the largest gap between a repeat and the first
(the step's figures, Adam's moments, the parameters and the BatchNorm
statistics, each class relative to its largest entry), the ops that had no
deterministic kernel (PyTorch's warnings), and the step time. Gaps in the
default mode and none under determinism put the run-to-run gap on the
atomics of scatter-adds (``torch.gather``'s backward); gaps in both put it
elsewhere. bf16 rounding is itself deterministic: it can only magnify a
gap, not start one. Ends with one JSON line, also written to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def run(mode: str, repeats: int, steps: int, cfg, batch) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from semantic_slam_master_tpu_torch.train import trainer

    torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
    trees, figures, times, notes = [], [], [], set()
    for _ in range(repeats):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model, state = trainer.create_train_state(cfg, 16, device="cuda")
            fresh = state.opt_state, state.step, state.rng
            state, _ = trainer.restore_checkpoint(chip_smoke.TINY_WEIGHTS, model, state)
            state.opt_state, state.step, state.rng = fresh
            tx = trainer.build_optimizer(cfg, 16, trainer.flax_order(state.trainable))
            step = trainer.make_train_step(model, cfg, tx)
            b = trainer.to_device(batch, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, out = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        notes |= {str(w.message).split("\n")[0][:160] for w in caught if "deterministic" in str(w.message)}
        figures.append({k: float(v) for k, v in out.items()})
        trees.append(trainer.checkpoint_tree(model, state))
    torch.use_deterministic_algorithms(False)
    fig_gap = max(chip_smoke.figure_gap(f, figures[0])[0] for f in figures[1:])
    arrays = {}
    for t in trees[1:]:
        for k, v in chip_smoke.tree_gaps(t, trees[0]).items():
            arrays[k] = max(arrays.get(k, 0.0), v)
    bitwise = all(np.array_equal(t[k], trees[0][k]) for t in trees[1:] for k in t)
    return {"mode": mode, "figure_gap": fig_gap, "array_gaps": arrays, "bit_equal": bitwise,
            "loss": [f["loss"] for f in figures], "seconds": times, "no_deterministic_kernel": sorted(notes)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--json", default=None)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_determinism: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from semantic_slam_master_tpu_torch.cli import train_cli
    from semantic_slam_master_tpu_torch.train import config as config_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="determinism_") as tmp:
        cfg = config_mod.load_config(chip_smoke.derive_config("init", tmp, os.path.join(tmp, "init.yaml")))
    batch = next(iter(train_cli._synthetic_pair_batches(cfg, split_seed=0)(1)))
    results = []
    for mode in ("default", "deterministic", "default"):
        r = run(mode, args.repeats, args.steps, cfg, batch)
        results.append(r)
        print(json.dumps(r), flush=True)
    summary = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "repeats": args.repeats,
               "steps": args.steps, "results": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
