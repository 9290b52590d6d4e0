#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the chip:

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For each seed: the world is rendered, one pass of the cell's drive runs
through the port, and the numbers that ``harness/check.py`` compares are
read for the port against the reference and, on the control seeds, for
the control (the reference one precision below the configuration's)
against the reference, whose SLAM loop follows the features of the run
it judges (``harness/reference_run.py``). One process holds the port, the reference and
the control. Prints one line per seed and run, then a JSON summary with
the largest port reading and the smallest control reading per number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None, help="write the JSON summary here too")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import numpy as np
    import torch

    from harness import bench, check, trace
    from harness import world as world_mod
    from harness.manifest import Manifest
    from harness.reference_run import Reference

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    r = bench.Run(Manifest(ROOT), args.workload, args.seeds[0], device)
    from harness import program as program_mod
    from reference.camera import PinholeCamera

    program_mod.build_kernels()
    prog = program_mod.Program(r.config, ROOT, device)
    ref = Reference(r.config, ROOT, device)
    ctl = Reference(r.config, ROOT, device, precision="control")
    cam = PinholeCamera(**r.config["camera"])
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        world = world_mod.render(r.traffic, cam, seed, r.config["slam"]["num_hypotheses"])
        tracer = trace.Tracer(device, False)
        res = r.drive.window(prog, world, 0.0, tracer, np.random.default_rng(seed))
        out = dict(res.sample, poses=res.poses, truth=world.poses_wc)
        want = ref.run(world, r.drive.WITH_SLAM, follow=out["features"])
        if seed in args.seeds:
            nums = check.numbers(r.config, out, want)
            rows.append({"seed": seed, "run": "port", **nums})
            print(json.dumps(rows[-1]), flush=True)
        if seed in args.control_seeds:
            got = ctl.run(world, r.drive.WITH_SLAM)
            if r.drive.WITH_SLAM:
                want = dict(want, poses=ref.slam(world.uniforms, got["features"]))
            cout = {"weight_map": got["weight_map"], "features": got["features"],
                    "poses": [got["poses"]] if got["poses"] is not None else [], "truth": world.poses_wc}
            nums = check.numbers(r.config, cout, want)
            rows.append({"seed": seed, "run": "control", **nums})
            print(json.dumps(rows[-1]), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", flush=True)
    names = [k for k in rows[0] if k not in ("seed", "run")]
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
               "power_limit_w": bench.power_limit_w(), "rows": rows}
    for n in names:
        port = [row[n] for row in rows if row["run"] == "port"]
        ctrl = [row[n] for row in rows if row["run"] == "control"]
        summary[n] = {"port_max": max(port) if port else None, "control_min": min(ctrl) if ctrl else None}
        print(f"{n}: port max {summary[n]['port_max']!r}, control min {summary[n]['control_min']!r}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
