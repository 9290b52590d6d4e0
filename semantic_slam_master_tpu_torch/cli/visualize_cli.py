"""Saliency and match visualisations (port of ``visualize``).

Modes:
- ``saliency``: the 9-panel edge-aware dashboard of one frame. Without
  ``--checkpoint`` the "saliency" is the FAST response pooled to 16-pixel
  cells, with the FAST keypoints; with it, the saliency map and keypoints
  of the ``LearnedFrontend`` of the default ``ModelConfig`` (ViT-S/16) with
  those weights (an ``.npz`` of its flax variables, as for ``run-slam
  --checkpoint``), run on the frame as it is;
- ``matches``: two frames side by side with their ORB matches;
- ``sequence``: the ORB matches of frame 0 with frames at several
  spacings, one row each.

The device half of each mode (``saliency_map``, ``orb_extract_and_match``)
runs on ``--device`` and hands numpy arrays to the plots.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device

ORB_KEYPOINTS = 400  # the JAX CLI's keypoint budget in every mode
FAST_THRESHOLD = 0.05
SALIENCY_CELL = 16  # FAST response pooled to the ViT's patch pitch


def _load_sequence(args):
    if args.synthetic:
        from ..data import synthetic

        return synthetic.make_sequence(num_frames=args.frames, scale=args.scale)
    from ..data.tum import TUMSequence

    return TUMSequence(args.data_root, args.sequence)


def saliency_map(rgb: np.ndarray, device, checkpoint: str | None = None):
    """(saliency (h, w), keypoints (K, 2) pixel xy) of one (H, W, 3) frame
    in [0, 1], as numpy: the learned frontend's with ``checkpoint``, else
    the FAST response average-pooled to 16-pixel cells, scaled to a maximum
    of 1, and the valid FAST keypoints."""
    x = torch.from_numpy(np.asarray(rgb, np.float32)).to(device)
    with torch.no_grad():
        if checkpoint:
            from .. import convert
            from ..train import config as config_mod

            model = config_mod.build_model(config_mod.ModelConfig())
            model.load_state_dict(convert.frontend_state_dict(checkpoint))
            out = model.to(device).eval()(x[None])
            return out.saliency[0, ..., 0].float().cpu().numpy(), out.keypoints_px[0].float().cpu().numpy()
        from ..ops import fast, image

        gray = image.rgb_to_gray(x[None])
        score = fast.fast_score(gray, FAST_THRESHOLD)
        h, w = score.shape[1] // SALIENCY_CELL, score.shape[2] // SALIENCY_CELL
        sal = image.avg_pool_to(score[:, : h * SALIENCY_CELL, : w * SALIENCY_CELL], h, w).cpu().numpy()[0]
        sal = sal / (sal.max() + 1e-8)
        kp = fast.detect(gray, ORB_KEYPOINTS, FAST_THRESHOLD)
        return sal, kp.xy[0][kp.valid[0]].cpu().numpy()


def orb_extract_and_match(device, num_keypoints: int = ORB_KEYPOINTS):
    """``fn(rgb1, rgb2) -> (xy1, xy2, matches (K, 2), similarities)``: the
    single-scale ORB adapter of the acceptance suite on both frames at
    once, Hamming-matched; every similarity is 1, as in the JAX CLI."""
    from ..eval.frontend_tests import orb_adapter

    adapter = orb_adapter(num_keypoints=num_keypoints, device=device)

    def fn(rgb1, rgb2):
        feats = adapter.extract(np.stack([rgb1, rgb2]))
        m = adapter.match(feats, 0, 1)
        return feats["xy"][0], feats["xy"][1], m, np.ones(len(m))

    return fn


def main(argv=None):
    parser = argparse.ArgumentParser(prog="visualize", description=__doc__)
    parser.add_argument("mode", choices=("saliency", "matches", "sequence"))
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-root", default="data/tum_rgbd")
    parser.add_argument("--sequence", default="rgbd_dataset_freiburg1_desk")
    parser.add_argument("--frames", type=int, default=25)
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--frame2", type=int, default=1)
    parser.add_argument("--spacings", nargs="*", type=int, default=(1, 5, 10, 15, 20))
    parser.add_argument("--checkpoint", default=None,
                        help="learned-frontend .npz (flax variables) for saliency mode")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    seq = _load_sequence(args)
    out_dir = Path(args.output or "visualizations")

    if args.mode == "saliency":
        rgb = seq.frame(args.frame)["rgb"]
        sal, kpts = saliency_map(rgb, device, args.checkpoint)
        from ..viz.saliency import saliency_dashboard

        stats = saliency_dashboard(rgb, sal, kpts, out_dir / "saliency_analysis.png")
        print(stats)
        print(f"wrote {out_dir / 'saliency_analysis.png'}")
    elif args.mode == "matches":
        f1, f2 = seq.frame(args.frame), seq.frame(args.frame2)
        k1, k2, m, sims = orb_extract_and_match(device)(f1["rgb"], f2["rgb"])
        from ..viz.matches import draw_matches

        draw_matches(f1["rgb"], f2["rgb"], k1, k2, m, sims, out_dir / "matches.png",
                     title=f"frames {args.frame}->{args.frame2}")
        print(f"{len(m)} matches; wrote {out_dir / 'matches.png'}")
    else:
        n = seq.num_frames() if hasattr(seq, "num_frames") else len(seq)
        frames = [seq.frame(i)["rgb"] for i in range(min(n, max(args.spacings) + 1))]
        from ..viz.matches import sequence_match_grid

        counts = sequence_match_grid(frames, orb_extract_and_match(device), args.spacings,
                                     out_dir / "matches_sequence.png")
        print(counts)
        print(f"wrote {out_dir / 'matches_sequence.png'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
