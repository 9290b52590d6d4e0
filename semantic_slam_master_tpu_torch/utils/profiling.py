"""Stage timing (port of ``utils/profiling.py``'s ``marginal_time_ms`` and
``time_fn``).

On a CUDA device a stage is timed with CUDA events; on the CPU with
``time.perf_counter``. ``marginal_time_ms`` runs the stage back to back at
two repetition counts and takes the difference per extra iteration, so
the fixed cost of starting and ending a timed run (event records, the
final synchronisation, Python's call overhead around the loop) cancels;
that fixed cost is returned as ``overhead_ms``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

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
