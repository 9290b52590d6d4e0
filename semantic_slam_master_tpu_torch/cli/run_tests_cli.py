"""The four-test frontend acceptance suite (port of ``run-tests``):
repeatability, descriptor quality, tracking and performance at a
difficulty preset, on TUM sequences (``--data-root``, ``--sequences``) or
the synthetic world (``--synthetic``), per-test pass/fail against the
reference thresholds, and the results as JSON (``--output``).

The exit code is 0 when every test of every sequence passes, 1 otherwise,
1 when no sequence could be read, and 1 when a test sequence is also one
of ``--train-sequences`` (inflated results) unless
``--allow-train-overlap``.

``--frontend learned`` builds the ``LearnedFrontend`` as ``run-slam``
does: the ``model:`` section of ``--config`` sizes it, ``--checkpoint``
takes an ``.npz`` of its flax variables (without one: seeded weights and
a warning). Frames are resized to the config's ``input_size``.

Each sequence's results are also drawn as a PNG dashboard,
``<output stem>_<sequence>.png``, unless ``--no-plots``; a plot that
fails (``matplotlib`` absent, say) is reported and never fails the suite.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..core.device import resolve_device


def strip_per_pair(obj):
    """``obj`` without its ``per_pair`` entries, at any depth."""
    if isinstance(obj, dict):
        return {k: strip_per_pair(v) for k, v in obj.items() if k != "per_pair"}
    if isinstance(obj, list):
        return [strip_per_pair(v) for v in obj]
    return obj


def main(argv=None):
    parser = argparse.ArgumentParser(prog="run-tests", description=__doc__)
    parser.add_argument("--frontend", choices=("orb", "orb-pyramid", "learned"), default="orb-pyramid",
                        help="default: the multi-scale ORB path that feeds SLAM (tracking.extract_features)")
    parser.add_argument("--num-levels", type=int, default=4, help="pyramid levels for --frontend orb-pyramid")
    parser.add_argument("--checkpoint", default=None,
                        help=".npz of flax LearnedFrontend variables for --frontend learned")
    parser.add_argument("--config", default=None,
                        help="training YAML whose model: section sizes --frontend learned")
    parser.add_argument("--difficulty", choices=("easy", "normal", "hard", "extreme"), default="normal")
    parser.add_argument("--data-root", default="data/tum_rgbd")
    parser.add_argument("--sequences", nargs="*", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic-frames", type=int, default=40)
    parser.add_argument("--train-sequences", nargs="*", default=None,
                        help="training sequences, for the overlap guard")
    parser.add_argument("--allow-train-overlap", action="store_true")
    parser.add_argument("--no-performance", action="store_true")
    parser.add_argument("--output", default="test_results.json")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from ..eval import frontend_tests

    if args.train_sequences and args.sequences:
        overlap = frontend_tests.check_sequence_overlap(args.sequences, args.train_sequences)
        if overlap and not args.allow_train_overlap:
            print("WARNING: evaluating on training sequences (inflated results): "
                  f"{overlap}\nPass --allow-train-overlap to proceed.", file=sys.stderr)
            return 1

    device = resolve_device(args.device)
    if args.frontend == "orb":
        adapter = frontend_tests.orb_adapter(device=device)
    elif args.frontend == "orb-pyramid":
        adapter = frontend_tests.pyramid_orb_adapter(num_levels=args.num_levels, device=device)
    else:
        from ..train import config as config_mod
        from .run_slam_cli import load_learned_frontend

        model = load_learned_frontend(argparse.Namespace(train_config=args.config, checkpoint=args.checkpoint),
                                      device)
        cfg = config_mod.load_model_config(args.config) if args.config else config_mod.ModelConfig()
        adapter = frontend_tests.learned_adapter(model, input_size=cfg.input_size, device=device)

    seqs = {}
    if args.synthetic:
        from ..data import synthetic

        seqs["synthetic_room"] = synthetic.make_sequence(num_frames=args.synthetic_frames, scale=0.5)
    else:
        from ..data.tum import TUMSequence

        for name in args.sequences or ["rgbd_dataset_freiburg1_desk"]:
            try:
                seqs[name] = TUMSequence(args.data_root, name)
            except FileNotFoundError as e:
                print(f"[run-tests] {name}: {e}", file=sys.stderr)
    if not seqs:
        print("no sequences available", file=sys.stderr)
        return 1

    all_results = {}
    for name, seq in seqs.items():
        print(f"== {name} ==")
        r = frontend_tests.run_all(seq, adapter, difficulty=args.difficulty,
                                   with_performance=not args.no_performance)
        all_results[name] = r
        for rep in r["repeatability"]:
            print(f"  repeatability (spacing {rep['spacing']}): {rep['mean_repeatability']:.3f} "
                  f"(target {rep['target']}) {'PASS' if rep['passed'] else 'FAIL'}")
        dq = r["descriptor_quality"]
        print(f"  descriptor quality: inlier {dq['inlier_ratio']:.3f} precision {dq['precision']:.3f} "
              f"{'PASS' if dq['passed'] else 'FAIL'}")
        for tr in r["tracking"]:
            print(f"  tracking (spacing {tr['spacing']}): {tr['success_rate']:.3f} "
                  f"{'PASS' if tr['passed'] else 'FAIL'}")
        if "performance" in r and "fps" in r["performance"]:
            print(f"  performance: {r['performance']['fps']:.1f} FPS")
        print(f"  => {'ALL PASS' if r['all_passed'] else 'FAILURES'}")
        if not args.no_plots:
            png = f"{Path(args.output).with_suffix('').as_posix()}_{name}.png"
            try:
                from ..viz import test_dashboard

                test_dashboard.acceptance_dashboard(r, png, sequence=name)
                print(f"  dashboard: {png}")
            except Exception as e:  # plots must never fail the suite
                print(f"  dashboard failed: {e}", file=sys.stderr)

    Path(args.output).write_text(json.dumps(strip_per_pair(all_results), indent=2))
    print(f"results: {args.output}")
    return 0 if all(r["all_passed"] for r in all_results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
