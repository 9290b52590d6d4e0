"""Stage timing, traces and cost counts (port of ``utils/profiling.py``).

On a CUDA device a stage is timed with CUDA events; on the CPU with
``time.perf_counter``. ``marginal_time_ms`` runs the stage back to back at
two repetition counts and takes the difference per extra iteration, so
the fixed cost of starting and ending a timed run (event records, the
final synchronisation, Python's call overhead around the loop) cancels;
that fixed cost is returned as ``overhead_ms``. ``device_trace`` records
a ``torch.profiler`` trace, ``stage_cost`` counts a stage's operations,
and ``StageTimer`` sums named host-clock stages.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


def _device_of(args) -> torch.device:
    """The device of the first tensor in ``args`` (nested tuples, lists and
    dicts searched), or the CPU."""
    stack = [args]
    while stack:
        a = stack.pop(0)
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
    return torch.device("cpu")


def _run_s(fn: Callable, args: tuple, iters: int, device: torch.device) -> float:
    """Seconds for ``iters`` back-to-back calls of ``fn(*args)``."""
    with torch.no_grad():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return time.perf_counter() - t0


def marginal_time_ms(fn: Callable, args: tuple, iters: int = 32, base_iters: int = 4) -> Dict[str, float]:
    """Per-call time of ``fn(*args)``: the best of three runs of ``iters``
    and of ``base_iters`` back-to-back calls (after one warm-up run of
    each), their difference divided by ``iters - base_iters``."""
    device = _device_of(args)
    _run_s(fn, args, base_iters, device)
    _run_s(fn, args, iters, device)
    t_base = min(_run_s(fn, args, base_iters, device) for _ in range(3))
    t_full = min(_run_s(fn, args, iters, device) for _ in range(3))
    per_iter = (t_full - t_base) / max(iters - base_iters, 1)
    return {
        "mean_ms": max(per_iter, 0.0) * 1e3,
        "overhead_ms": max(t_base - per_iter * base_iters, 0.0) * 1e3,
        "iters": iters,
    }


def time_fn(fn: Callable[[], object], warmup: int = 3, iters: int = 10,
            device: str | torch.device = "cpu") -> Dict[str, float]:
    """Latency of ``fn()`` in milliseconds over ``iters`` calls after
    ``warmup``, each timed alone (CUDA events on a CUDA ``device``)."""
    device = torch.device(device)
    for _ in range(warmup):
        _run_s(lambda: fn(), (), 1, device)
    times = sorted(_run_s(lambda: fn(), (), 1, device) * 1e3 for _ in range(iters))
    n = len(times)
    return {
        "mean_ms": sum(times) / n,
        "p50_ms": times[n // 2],
        "min_ms": times[0],
        "max_ms": times[-1],
        "iters": n,
    }


def stage_cost(fn: Callable, args: tuple) -> Dict[str, float]:
    """{"flops", "bytes"} of one call of ``fn(*args)``. The flops are
    ``torch.utils.flop_counter.FlopCounterMode``'s count, which covers the
    operators PyTorch has formulas for (matrix products, convolutions,
    attention) and counts nothing for elementwise work. PyTorch exposes no
    count of the bytes a call moves, so "bytes" is 0, as the JAX function
    returns zeros where its backend has no cost analysis."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()), "bytes": 0.0}


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace (host and, with a card, CUDA
    activity) of the block into ``log_dir``, in the TensorBoard layout;
    does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StageTimer:
    """Accumulating named-stage wall timer for host-side loops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                "count": self.counts[k],
            }
            for k in self.totals
        }
