"""``python -m semantic_slam_master_tpu_torch <command>`` dispatcher."""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "run-slam": ("semantic_slam_master_tpu_torch.cli.run_slam_cli", "synthetic-world SLAM -> TUM trajectory"),
    "evaluate": ("semantic_slam_master_tpu_torch.cli.evaluate_cli", "ATE/RPE evaluation -> results.json"),
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
