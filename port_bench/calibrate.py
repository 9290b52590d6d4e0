#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the chip:

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For each seed: the world is rendered, one pass of the cell's drive runs
through the port, and the numbers that ``harness/check.py`` compares are
read for the port against the reference and, on the control seeds, for
the control (the reference one precision below the configuration's)
against the reference, whose SLAM loop follows the features of the run
it judges (``harness/reference_run.py``). One process builds the port,
the control and the reference in turn, each freed before the next, so
that a model the card holds once is never held twice; the worlds and
the outputs stay between them. Prints one line per seed and run, then a
JSON summary with the largest port reading and the smallest control
reading per number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(r, seeds, control_seeds, render_workers=None) -> list:
    """One row per seed and run (``port``, ``control``) of the numbers
    ``harness/check.py`` compares, for the cell of ``bench.Run`` ``r`` on
    its device. The port, the control and the reference are built in
    turn, each freed before the next."""
    import numpy as np

    from harness import bench, check, trace
    from harness import program as program_mod
    from harness import world as world_mod
    from harness.reference_run import Reference
    from reference.camera import PinholeCamera

    device = r.device
    if device.type == "cuda":
        program_mod.build_kernels()
    cam = PinholeCamera(**r.config["camera"])
    worlds = {s: world_mod.render(r.traffic, cam, s, r.config["slam"]["num_hypotheses"],
                                  render_workers or world_mod.RENDER_WORKERS)
              for s in sorted(set(seeds) | set(control_seeds))}

    def timed(what, seed, t):
        print(f"{what} seed {seed}: {time.perf_counter() - t:.1f} s", flush=True)

    prog = program_mod.Program(r.config, r.manifest.root, device)
    port_shapes, port_out = prog.weight_shapes, {}
    for seed in seeds:
        t, world = time.perf_counter(), worlds[seed]
        res = r.drive.window(prog, world, 0.0, trace.Tracer(device, False), np.random.default_rng(seed))
        port_out[seed] = dict(res.sample, poses=res.poses, truth=world.poses_wc)
        timed("port", seed, t)
    del prog, res
    bench.free(device)
    ctl_out = {}
    if control_seeds:
        ctl = Reference(r.config, r.manifest.root, device, precision="control")
        bench.same_weights(port_shapes, ctl)
        for seed in control_seeds:
            t = time.perf_counter()
            ctl_out[seed] = ctl.run(worlds[seed], r.drive.WITH_SLAM)
            timed("control", seed, t)
        del ctl
        bench.free(device)
    ref = Reference(r.config, r.manifest.root, device)
    bench.same_weights(port_shapes, ref)
    rows = []
    for seed, world in worlds.items():
        t, got = time.perf_counter(), ctl_out.get(seed)
        follow = port_out[seed]["features"] if seed in port_out else got["features"]
        want = ref.run(world, r.drive.WITH_SLAM, follow=follow)
        if seed in port_out:
            rows.append({"seed": seed, "run": "port", **check.numbers(r.config, port_out[seed], want)})
            print(json.dumps(rows[-1]), flush=True)
        if got is not None:
            if r.drive.WITH_SLAM and seed in port_out:
                want = dict(want, poses=ref.slam(world.uniforms, got["features"]))
            cout = {"weight_map": got["weight_map"], "features": got["features"],
                    "poses": [got["poses"]] if got["poses"] is not None else [], "truth": world.poses_wc}
            rows.append({"seed": seed, "run": "control", **check.numbers(r.config, cout, want)})
            print(json.dumps(rows[-1]), flush=True)
        timed("reference", seed, t)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None, help="write the JSON summary here too")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from harness import bench
    from harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    r = bench.Run(Manifest(ROOT), args.workload, args.seeds[0], device)
    rows = readings(r, args.seeds, args.control_seeds)
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
