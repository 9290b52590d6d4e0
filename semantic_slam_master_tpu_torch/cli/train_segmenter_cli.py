"""``train-segmenter`` -- train the semantic segmentation CNN on the
synthetic world (port of the JAX package's CLI, same flags, plus
``--device``). The labels are rendered, so no dataset is needed. The
``.npz`` checkpoint feeds ``run-slam --semantics model
--segmenter-checkpoint``. Runs on the card unless ``--device cpu``;
without a card it raises.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="train-segmenter", description=__doc__)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--height", type=int, default=120)
    parser.add_argument("--width", type=int, default=160)
    parser.add_argument("--model-width", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", default="checkpoints/segmenter.npz")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from ..train import seg_trainer

    model, metrics = seg_trainer.train(num_steps=args.steps, batch_size=args.batch_size, lr=args.lr,
                                       image_hw=(args.height, args.width), seed=args.seed,
                                       width=args.model_width, device=args.device)
    out = seg_trainer.save_checkpoint(args.output, model)
    print(f"saved segmenter checkpoint to {out} "
          f"(final loss={metrics['loss']:.4f}, acc={metrics['accuracy']:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
