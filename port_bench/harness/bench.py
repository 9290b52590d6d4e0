"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import check, trace, weights, world as world_mod
from .manifest import Manifest
from .readers import Context

FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_slam_master_tpu")


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def free(device: torch.device) -> None:
    """Return the memory of dropped models to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def same_weights(port_shapes: dict, reference) -> None:
    """Raise unless each reference model has the port's state-dict keys
    and shapes."""
    for what, shapes in port_shapes.items():
        weights.same_shapes(shapes, reference.weight_shapes[what], what)


class Run:
    """The parts of a run, so that tests can drive them on the CPU."""

    def __init__(self, manifest: Manifest, workload: str, seed: int, device: torch.device,
                 render_workers: int = world_mod.RENDER_WORKERS):
        self.manifest, self.seed, self.device = manifest, seed, device
        self.cell = manifest.cell(workload)
        self.config = manifest.config(self.cell)
        self.traffic = manifest.traffic(self.cell)
        self.drive = manifest.drive(self.traffic)
        self.render_workers = render_workers

    def setup(self):
        from . import program  # the port; imported here so that set-up counts it

        if self.device.type == "cuda":
            log(f"kernel build: {program.build_kernels():.1f} s")
        from reference.camera import PinholeCamera

        cam = PinholeCamera(**self.config["camera"])
        t = time.perf_counter()
        self.world = world_mod.render(self.traffic, cam, self.seed, self.config["slam"]["num_hypotheses"],
                                      self.render_workers)
        log(f"render of {self.traffic['frames']} frames: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        self.program = program.Program(self.config, self.manifest.root, self.device)
        log(f"models: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        self.drive.warm(self.program, self.world, trace.Tracer(self.device, False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"warm pass: {time.perf_counter() - t:.1f} s")

    def window(self, seconds: float, traced: bool):
        self.tracer = trace.Tracer(self.device, traced)
        rng = np.random.default_rng([int(self.seed) % (2**63), 0xA11])
        self.result = self.drive.window(self.program, self.world, seconds, self.tracer, rng)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.result

    def check(self):
        """Frees the port's state, runs the reference over the same world
        and compares; returns (correct, failed, {name: [value, limit]})."""
        from .reference_run import Reference

        out = dict(self.result.sample, poses=self.result.poses, truth=self.world.poses_wc)
        port_shapes = self.program.weight_shapes
        self.program = None
        free(self.device)
        t = time.perf_counter()
        reference = Reference(self.config, self.manifest.root, self.device)
        same_weights(port_shapes, reference)
        ref = reference.run(self.world, self.drive.WITH_SLAM, follow=out["features"])
        log(f"reference: {time.perf_counter() - t:.1f} s")
        if ref["poses"] is not None and out["poses"]:
            log(f"{reference.keyframes} keyframes")
        nums = check.numbers(self.config, out, ref)
        correct, table = check.judge(self.config, nums)
        failed = 0 if correct else max(1, check.failed_passes(self.config, out, ref))
        return correct, failed, table

    def per_layer(self) -> dict:
        ctx = Context(self.config, self.traffic, self.world, self.tracer.summary, self.device)
        out = {}
        for m in self.manifest.per_layer(self.cell):
            value = self.manifest.reader(m["name"]).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def run(root, workload: str, seed: int, seconds: float, traced: bool, process_start: float) -> int:
    manifest = Manifest(root)
    cell = manifest.cell(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    device = torch.device("cuda:0")
    r = Run(manifest, workload, seed, device)
    r.setup()
    setup_s = time.perf_counter() - process_start
    log(f"set-up: {setup_s:.3f} s")
    res = r.window(seconds, traced)
    peak = torch.cuda.max_memory_allocated(device)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}: no result")
        return 4
    log(f"window: {res.passes} passes, {res.frames} frames in {res.elapsed_s:.3f} s; "
        + ", ".join(f"{k} {v}" for k, v in {**res.metrics, **res.notes}.items()))
    log("pass seconds: " + " ".join(f"{s:.4f}" for s in res.pass_s))
    metrics = {}
    if traced:
        metrics = r.per_layer()
    else:
        for m in manifest.end_to_end(cell):
            value = setup_s if m["name"] == "setup_s" else res.metrics[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, failed, table = r.check()
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
                   "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w()}
    line = {"correct": bool(correct), "attempted": int(res.attempted), "failed": int(failed),
            "metrics": metrics, "device": device_info}
    if traced:
        s = r.tracer.summary
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        line["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    line["checks"] = table
    for name, (value, limit) in table.items():
        log(f"check {name}: {value!r} limit {limit!r}")
    print(json.dumps(line), flush=True)
    return 0

