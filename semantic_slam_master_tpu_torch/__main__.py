"""``python -m semantic_slam_master_tpu_torch <command>`` dispatcher."""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "run-slam": ("semantic_slam_master_tpu_torch.cli.run_slam_cli", "TUM or synthetic-world SLAM -> TUM trajectory"),
    "evaluate": ("semantic_slam_master_tpu_torch.cli.evaluate_cli", "ATE/RPE evaluation -> results.json"),
    "run-tests": ("semantic_slam_master_tpu_torch.cli.run_tests_cli", "four-test frontend acceptance suite"),
    "associate": ("semantic_slam_master_tpu_torch.cli.associate_cli", "RGB/depth timestamp association"),
    "train": ("semantic_slam_master_tpu_torch.cli.train_cli", "train the learned frontend"),
    "train-segmenter": ("semantic_slam_master_tpu_torch.cli.train_segmenter_cli", "train the segmentation CNN on synthetic labels"),
    "check-setup": ("semantic_slam_master_tpu_torch.cli.check_setup_cli", "environment/dataset checks"),
    "download-tum": ("semantic_slam_master_tpu_torch.cli.download_tum_cli", "TUM RGB-D downloader"),
    "visualize": ("semantic_slam_master_tpu_torch.cli.visualize_cli", "saliency/match visualizations"),
    "bench": ("semantic_slam_master_tpu_torch.cli.bench_cli", "per-stage performance report"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m semantic_slam_master_tpu_torch <command> [args]\n")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:<14} {desc}")
        return 0
    if argv[0] not in COMMANDS:
        print(f"unknown command: {argv[0]}", file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[argv[0]][0])
    return module.main(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
