"""ATE/RPE trajectory evaluation (port of ``evaluate``).

Reads ``<sequence>_trajectory.txt`` files and their ground truth, computes
ATE (Umeyama, no scale) and RPE, and writes ``results.json``. A sequence
that fails (an unreadable file, too few matched timestamps) is recorded
as ``{"status": "error", "error": ...}`` and the others are still scored.
The JAX CLI's ``--plots`` is not ported yet: it waits for the port of
``viz/``, and no plots are written.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data import trajectory_io
from ..eval import ate_rpe


def main(argv=None):
    parser = argparse.ArgumentParser(prog="evaluate", description=__doc__)
    parser.add_argument("--trajectories", default="experiments/trajectories",
                        help="dir with <sequence>_trajectory.txt files")
    parser.add_argument("--data-root", default="data/tum_rgbd",
                        help="dir with <sequence>/groundtruth.txt")
    parser.add_argument("--sequences", nargs="*", default=None)
    parser.add_argument("--output", default=None,
                        help="results.json path (default: <trajectories>/results.json)")
    parser.add_argument("--rpe-delta", type=int, default=10)
    parser.add_argument("--max-diff", type=float, default=0.01)
    args = parser.parse_args(argv)

    traj_dir = Path(args.trajectories)
    out_path = Path(args.output) if args.output else traj_dir / "results.json"
    sequences = args.sequences or sorted(
        p.name[: -len("_trajectory.txt")] for p in traj_dir.glob("*_trajectory.txt")
    )

    results = {}
    for seq in sequences:
        traj_file = traj_dir / f"{seq}_trajectory.txt"
        gt_candidates = [
            Path(args.data_root) / seq / "groundtruth.txt",
            traj_dir / f"{seq}_groundtruth.txt",
        ]
        gt_file = next((p for p in gt_candidates if p.exists()), None)
        if not traj_file.exists():
            results[seq] = {"status": "missing_trajectory"}
            continue
        if gt_file is None:
            results[seq] = {"status": "missing_groundtruth"}
            continue
        try:
            t_est, p_est = trajectory_io.read_tum_trajectory(traj_file)
            t_gt, p_gt = trajectory_io.read_tum_trajectory(gt_file)
            results[seq] = ate_rpe.evaluate_trajectory(
                t_gt, p_gt, t_est, p_est, rpe_delta=args.rpe_delta, max_diff=args.max_diff
            )
        except Exception as e:  # per-sequence failure tolerance, as the JAX CLI
            results[seq] = {"status": "error", "error": str(e)}

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2))
    ok = [s for s, r in results.items() if r.get("status") == "success"]
    print(f"\n{'Sequence':<50} {'ATE RMSE':<12} {'RPE Trans':<12}")
    print("-" * 74)
    for seq in ok:
        ate = results[seq]["ate"]["rmse"]
        rpe = results[seq].get("rpe", {}).get("translation", {}).get("rmse")
        rpe_str = f"{rpe:<12.4f}" if isinstance(rpe, float) else f"{'N/A':<12}"
        print(f"{seq:<50} {ate:<12.4f} {rpe_str}")
    failed = [s for s in results if s not in ok]
    if failed:
        print(f"\nfailed: {failed}")
    print(f"\nresults: {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
