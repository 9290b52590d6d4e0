#!/usr/bin/env python3
"""Time the port's kernels against an older build of them, in one process
on one NVIDIA GPU.

    python3 profile_kernels.py [--old-csrc DIR] [--variant-csrc LABEL=DIR ...] [--rounds 2]
                               [--only orb|gather] [--json FILE]

Builds ``semantic_slam_master_tpu_torch/csrc/*.cu`` (printing each
kernel's registers and shared memory) and, with ``--old-csrc``, the
``*.cu`` files of DIR (an older tree's ``csrc/``, unpacked with ``git
archive`` into a git-ignored directory) into a second library, and each
``--variant-csrc`` directory into one more. Then, on
two inputs per kernel -- random frames (``chip_smoke.py``'s texture at
the pyramid shapes; its random keypoints with edge cases), and what the
ORB path hands the kernels for one 16-frame chunk of the rendered world
(the four pyramid levels; their blurred levels and detections) -- it
checks every build bit-exact against the plain version, and
times each per chunk (the four levels summed, median of 20 launches with
the L2 flushed, as ``chip_smoke.py`` times; and the four launched back to
back between one pair of events, as the path launches them; and
amortized: 30 launches back to back per level between one pair of
events, cycling through copies of the data that together exceed the L2,
divided by 30) in turns: old, the variants, new, new, the variants,
old; ``--rounds`` times over.

The learned path's ``gather_patches`` is timed alike on what it hands the
kernel per 8-frame chunk (8 x 500 centres on distinct cells of the 30x40
patch grid, 21x21 windows from 8x480x640): per launch with the L2
flushed; back to back (30 launches on the same inputs between one pair of
events, per launch); amortized over 30 cold launches (as above); and at
125, 250, 500 and 1000 keypoints per frame, per launch, to which a fixed
cost plus a cost per keypoint is fitted for each build. Its plain version
and one ``torch.gather`` over the precomputed index are timed beside it,
and two yardsticks: one window back to back (a launch with almost no
work) and a ``copy_`` of an output-sized tensor.

Prints the card's name and power limit, the floor of the timing (one
launch with almost no work), one line per timing (for fast_score also a
``copy_`` of the same frames, which moves the same bytes) and one JSON
summary, also written to FILE with ``--json``. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

L2_EXCEED_BYTES = 64 * 1024 * 1024  # the H100's L2 holds 50 MB
GATHER_SHAPE = (8, 480, 640)  # one 8-frame learned chunk
GATHER_RADIUS = 10
GATHER_FIT_N = (125, 250, 500, 1000)  # keypoints per frame; 500 is the path's


def amortized_ms(torch, launches, spin_cycles: int, reps: int = 30) -> float:
    """Device ms per launch over ``reps`` launches back to back between one
    pair of CUDA events, cycling through ``launches`` (one per copy of the
    inputs and outputs, together larger than the L2, so that a launch finds
    its data cold, as on the path): no event overhead per launch. A device
    spin first lets the host enqueue every launch before the first runs."""
    for f in launches:
        f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    for i in range(reps):
        launches[i % len(launches)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fit_line(points) -> tuple:
    """Least-squares (fixed, slope) of y = fixed + slope * x over (x, y)."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    slope = sum((x - mx) * (y - my) for x, y in points) / sum((x - mx) ** 2 for x, _ in points)
    return my - slope * mx, slope


def profile_gather(torch, cs, build, kgather, libs: dict, order: list, rounds: int, flush) -> dict:
    """gather_patches old against new at the learned path's shape (see the
    module docstring); returns the summary's entry."""
    B, H, W = GATHER_SHAPE
    radius = GATHER_RADIUS
    side = 2 * radius + 1
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = {}
    for n in GATHER_FIT_N:
        img = torch.randn((B, H, W), generator=gen, device="cuda")
        cases[n] = (img, cs.grid_centres(torch, gen, B, H, W, n),
                    torch.empty((B, n, side, side), device="cuda"))

    def launcher(lib):
        def run(img, xy, out):
            build.check(lib.semslam_gather_patches(img.data_ptr(), xy.data_ptr(), out.data_ptr(), B, xy.shape[1],
                                                   H, W, radius, side, *kgather.window_bounds(img, radius, side),
                                                   stream), "gather_patches")
        return run

    runs = {label: launcher(lib) for label, lib in libs.items()}
    for n, (img, xy, out) in cases.items():
        ref = kgather.gather_patches_reference(img, xy, radius, side)
        for label, run in runs.items():
            out.zero_()
            run(img, xy, out)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"gather_patches {label} at N={n} differs from the plain version")
    path = cases[500]
    img, xy, out = path
    n_copies = max(2, -(-L2_EXCEED_BYTES // sum(t.numel() * t.element_size() for t in path)))
    copies = [tuple(t.clone() for t in path) for _ in range(n_copies)]
    idx = kgather.window_index(xy, W, radius, side, *kgather.window_bounds(img, radius, side))
    n_read = cs.unique_pixels(idx, H * W)
    bound_ms, _ = cs.bound(n_read * 4 + B * 500 * (8 + side * side * 4), 0.0)
    flat = img.reshape(B, H * W)
    entry = {
        "bound_ms": bound_ms,
        "plain_ms": cs.median_ms(lambda: kgather.gather_patches_reference(img, xy, radius, side), cs.PLAIN_ITERS,
                                 1, flush),
        "library_ms": cs.median_ms(lambda: torch.gather(flat, 1, idx), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush),
        "times": {}, "fit": {},
    }
    # Yardsticks: one window (a launch with almost no work) back to back,
    # and a torch copy_ of a tensor the size of the output.
    one = (img, xy[:1, :1].clone(), torch.empty((1, 1, side, side), device="cuda"))
    src = torch.empty_like(out)
    entry["one window, back to back"] = amortized_ms(torch, [lambda: runs["new"](*one)], 2 * cs.SPIN_CYCLES)
    entry["output-sized copy_, back to back"] = amortized_ms(torch, [lambda: out.copy_(src)], 2 * cs.SPIN_CYCLES)
    entry["output-sized copy_"] = cs.median_ms(lambda: out.copy_(src), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
    print(f"  gather_patches path {GATHER_SHAPE} N=500 r={radius}: bound_ms={bound_ms:.4f} (bytes; distinct "
          f"pixels {n_read}) plain_ms={entry['plain_ms']:.4f} library_ms={entry['library_ms']:.4f}; yardsticks: "
          f"one window back to back {entry['one window, back to back']:.4f}, output-sized copy_ "
          f"{entry['output-sized copy_']:.4f} (back to back {entry['output-sized copy_, back to back']:.4f})",
          flush=True)
    times, fit_points = entry["times"], {}
    for rnd in range(rounds):
        for label in order:
            run = runs[label]
            per_launch = cs.median_ms(lambda: run(img, xy, out), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
            back_to_back = amortized_ms(torch, [lambda: run(img, xy, out)], 2 * cs.SPIN_CYCLES)
            amortized = amortized_ms(torch, [lambda c=c: run(*c) for c in copies], 2 * cs.SPIN_CYCLES)
            by_n = {n: cs.median_ms(lambda c=c: run(*c), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
                    for n, c in cases.items()}
            fit_points.setdefault(label, []).extend((B * n, t) for n, t in by_n.items())
            for key, t in (("", per_launch), (", back to back", back_to_back), (", amortized", amortized)):
                times.setdefault(label + key, []).append(t)
            times.setdefault(label + ", by keypoints per frame", []).append(by_n)
            print(f"  gather_patches round {rnd} {label}: {per_launch:.4f} ms per chunk "
                  f"(share of bound {bound_ms / per_launch:.3f}); back to back {back_to_back:.4f}; amortized "
                  f"{amortized:.4f}; per launch at N = "
                  + " ".join(f"{n}: {t:.4f}" for n, t in by_n.items()), flush=True)
    for label, points in fit_points.items():
        fixed, slope = fit_line(points)
        entry["fit"][label] = {"fixed_us": fixed * 1e3, "ns_per_keypoint": slope * 1e6}
        rate = (side * side * 4 * 2) / (slope * 1e-3) / 1e12 if slope > 0 else float("nan")
        print(f"  gather_patches {label}: fitted {fixed * 1e3:.2f} us + {slope * 1e6:.3f} ns per keypoint "
              f"({rate:.2f} TB/s at the margin, counting each window read and written once)", flush=True)
    return entry


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--old-csrc", default=None, help="directory of an older tree's csrc/*.cu")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--variant-csrc", action="append", default=[], metavar="LABEL=DIR",
                        help="a further build to time in the same turns (repeatable)")
    parser.add_argument("--only", choices=("orb", "gather"), default=None,
                        help="time only the ORB path's kernels or only gather_patches")
    parser.add_argument("--json", default=None, help="also write the JSON summary to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from semantic_slam_master_tpu_torch.cli.run_slam_cli import render_all
    from semantic_slam_master_tpu_torch.data import synthetic
    from semantic_slam_master_tpu_torch.ops import fast, image
    from semantic_slam_master_tpu_torch.ops.kernels import build
    from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
    from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
    from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch
    from semantic_slam_master_tpu_torch.slam import tracking

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    secs = build.compile_library(build.sources(), build.LIB_PATH, ["-Xptxas", "-v"], verbose=True)
    print(f"built {build.LIB_PATH.name} in {secs:.2f} s", flush=True)
    libs = {"new": build.library()}
    others = ([("old", args.old_csrc)] if args.old_csrc else []) + [v.split("=", 1) for v in args.variant_csrc]
    for label, src_dir in others:
        src_dir = Path(src_dir)
        lib_path = src_dir / "_build" / f"libsemslam_{label}.so"
        secs = build.compile_library(sorted(src_dir.glob("*.cu")), lib_path, ["-Xptxas", "-v"], verbose=True)
        print(f"built {lib_path} in {secs:.2f} s", flush=True)
        libs[label] = build.load(lib_path)
    # Turns: old, the variants, new, then the same backwards.
    labels = [label for label, _ in others] + ["new"]
    order = labels + labels[::-1]

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    path = cs.path_inputs(torch, synthetic, render_all, tracking, fast, image) if args.only != "gather" else []
    fast_inputs = {"random": [cs.texture(torch, s, gen) for s in cs.FAST_SHAPES],
                   "path": [lvl for lvl, _, _ in path]}
    patch_inputs = {"random": [], "path": [(blurred, xy) for _, blurred, xy in path]}
    for (B, H, W), N in cs.PATCH_CASES:
        img = torch.rand((B, H, W), generator=gen, device="cuda") * 1.2 - 0.1
        xy = torch.rand((B, N, 2), generator=gen, device="cuda") * torch.tensor([W + 10.0, H + 10.0],
                                                                                 device="cuda") - 5.0
        xy[:, :4] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [W - 17.5, H - 16.5], [14.5, 15.5]],
                                 device="cuda")
        patch_inputs["random"].append((img, xy))
    stream = torch.cuda.current_stream().cuda_stream

    def fast_call(lib):
        def run(img, out):
            B, H, W = img.shape
            build.check(lib.semslam_fast_score(img.data_ptr(), out.data_ptr(), B, H, W, cs.FAST_THRESHOLD, stream),
                        "fast_score")
        return run

    def patch_call(lib):
        def run(inp, out):
            img, xy = inp
            B, H, W = img.shape
            build.check(lib.semslam_aligned_patches(img.data_ptr(), xy.data_ptr(), out.data_ptr(), B,
                                                    xy.shape[1], H, W, stream), "aligned_patches")
        return run

    # Launchers by label: the new and the old build.
    fast_runs = {name: fast_call(lib) for name, lib in libs.items()}
    patch_runs = {name: patch_call(lib) for name, lib in libs.items()}

    def clone(c):
        return c.clone() if isinstance(c, torch.Tensor) else tuple(t.clone() for t in c)

    def nbytes(c, o):
        return sum(t.numel() * t.element_size() for t in ((c,) if isinstance(c, torch.Tensor) else c) + (o,))

    kernels = {
        "fast_score": (fast_inputs, lambda img: torch.empty_like(img),
                       lambda img: kfast.fast_score_plain(img, cs.FAST_THRESHOLD), fast_runs),
        "gather_aligned_patches": (
            patch_inputs,
            lambda inp: torch.empty((*inp[1].shape[:2], 32, 32), dtype=torch.bfloat16, device="cuda"),
            lambda inp: kpatch.gather_aligned_patches_plain(*inp), patch_runs),
    }
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    summary = {"device": smi, "kernels": {}}
    # The floor of the timing itself: one launch with almost no work.
    one, one_out, word = torch.zeros((1, 1, 1), device="cuda"), torch.zeros((1, 1, 1), device="cuda"), \
        torch.zeros(1, device="cuda")
    summary["floor_ms"] = {
        "one-pixel fast_score": cs.median_ms(lambda: fast_runs["new"](one, one_out), cs.TIMED_ITERS,
                                             cs.WARMUP_ITERS, flush),
        "one-element torch zero_": cs.median_ms(word.zero_, cs.TIMED_ITERS, cs.WARMUP_ITERS, flush),
    }
    print(f"  timing floor: {summary['floor_ms']}", flush=True)
    for name, (inputs, alloc, plain, runs) in (kernels.items() if args.only != "gather" else ()):
        for kind, cases in inputs.items():
            outs = [alloc(c) for c in cases]
            refs = [plain(c) for c in cases]
            for label, run in runs.items():
                for c, o, r in zip(cases, outs, refs):
                    o.zero_()
                    run(c, o)
                    torch.cuda.synchronize()
                    if not torch.equal(o, r):
                        raise AssertionError(f"{name} {label} on {kind} input differs from the plain version")
            # Per level, enough copies of (input, output) to exceed the L2 for the amortized timing.
            rotations = [[(clone(c), alloc(c)) for _ in range(max(2, -(-L2_EXCEED_BYTES // nbytes(c, o))))]
                         for c, o in zip(cases, outs)]
            times = {}
            for rnd in range(args.rounds):
                for label in order:
                    per_level = [cs.median_ms(lambda: runs[label](c, o), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
                                 for c, o in zip(cases, outs)]
                    back_to_back = cs.median_ms(lambda: [runs[label](c, o) for c, o in zip(cases, outs)],
                                                cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
                    amortized = [amortized_ms(torch, [lambda c=c, o=o: runs[label](c, o) for c, o in copies],
                                              2 * cs.SPIN_CYCLES)
                                 for copies in rotations]
                    times.setdefault(label, []).append(sum(per_level))
                    times.setdefault(label + ", levels back to back", []).append(back_to_back)
                    times.setdefault(label + ", amortized", []).append(sum(amortized))
                    print(f"  {name} {kind} round {rnd} {label}: {sum(per_level):.4f} ms per chunk "
                          f"(levels {' '.join(f'{t:.4f}' for t in per_level)}; back to back "
                          f"{back_to_back:.4f}; amortized {sum(amortized):.4f}, levels "
                          f"{' '.join(f'{t:.4f}' for t in amortized)})", flush=True)
            if name == "fast_score":  # yardstick: a plain copy moves the same 8 bytes a pixel
                copy = [cs.median_ms(lambda: o.copy_(c), cs.TIMED_ITERS, cs.WARMUP_ITERS, flush)
                        for c, o in zip(cases, outs)]
                times["torch copy_ of the same frames (yardstick)"] = [sum(copy)]
                print(f"  {name} {kind} yardstick torch copy_: {sum(copy):.4f} ms per chunk "
                      f"(levels {' '.join(f'{t:.4f}' for t in copy)})", flush=True)
            summary["kernels"].setdefault(name, {})[kind] = times
    if args.only != "orb":
        summary["kernels"]["gather_patches"] = profile_gather(torch, cs, build, kgather, libs, order, args.rounds,
                                                            flush)
    line = json.dumps(summary)
    print(line, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
