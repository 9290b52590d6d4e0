#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one cell, one run:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks the window's output
against the plain reference, and prints one JSON line last on standard
output (see README.md). Exits non-zero, with no result, without a CUDA
device.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    import os

    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    process_start = START - process_age_s()
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import bench

    return bench.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), process_start)


if __name__ == "__main__":
    raise SystemExit(main())
