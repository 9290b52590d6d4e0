"""Stage timing, traces, cost counts and the program's recorder (port of
``utils/profiling.py``).

On a CUDA device a stage is timed with CUDA events; on the CPU with
``time.perf_counter``. ``marginal_time_ms`` runs the stage back to back at
two repetition counts and takes the difference per extra iteration, so
the fixed cost of starting and ending a timed run (event records, the
final synchronisation, Python's call overhead around the loop) cancels;
that fixed cost is returned as ``overhead_ms``. ``device_trace`` records
a ``torch.profiler`` trace and ``stage_cost`` counts a stage's operations.

The recorder: the program opens a ``span`` around each layer's work,
``count``s what it does there, and wraps each point where the host waits
for the device (a device value read on the host, a blocking copy from the
host) in a ``sync``. A span with no open parent on its thread is a
root call; ``calls()`` returns the completed root calls, each with the
count, host time, self time and device time of every span inside it and
its counters. Recording is always on; ``enabled`` exists to measure what
it costs.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

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


# --- The program's recorder ------------------------------------------------

enabled = True  # switched off only to measure what recording costs
MAX_CALLS = 8192  # completed root calls kept, newest last
HOST_SYNCS = "host_syncs"  # the counter every ``sync`` adds to

_calls: deque = deque(maxlen=MAX_CALLS)
_ids = itertools.count()
_local = threading.local()
_pending: list = []  # (stat, start event, end event) of device spans not yet read
_pending_lock = threading.Lock()


class _Root:
    """A root call as it is recorded: per span name [count, host_ns,
    self_ns, device_ms] (device_ms None for a span without a device)."""

    __slots__ = ("id", "name", "frames", "profiled", "spans", "counters")

    def __init__(self, name: str, frames):
        self.id, self.name, self.frames = None, name, frames
        self.profiled = False
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _read_events(block: bool) -> None:
    """Add the device time of each recorded device span whose end event has
    completed (all of them, waiting, when ``block``) to its span's stat."""
    global _pending
    with _pending_lock:
        left = []
        for stat, start, end in _pending:
            if block:
                end.synchronize()
            elif not end.query():
                left.append((stat, start, end))
                continue
            stat[3] += start.elapsed_time(end)
        _pending = left


class span:
    """``with span(name, frames=None, device=None):`` records the block's
    host time (``time.perf_counter_ns``), and its self time (less its
    child spans'), in this thread's open root call, or opens a root call of
    ``frames`` frames when none is open. Given a CUDA ``device``, it also records a CUDA event pair on
    that device's current stream, read when the records are read, with no
    synchronise. While a ``torch.profiler`` runs, the block is also a
    range of the same name in its trace, on the trace's clock: a host op
    (``_RecordFunctionFast``), not a ``record_function`` user annotation,
    whose copy on the device's timeline a trace's reader would take for
    device work."""

    __slots__ = ("name", "frames", "device", "_root", "_t0", "_child_ns", "_start", "_range", "_on")

    def __init__(self, name: str, frames: Optional[int] = None, device=None):
        self.name, self.frames, self.device = name, frames, device

    def __enter__(self):
        self._on = enabled
        if not self._on:
            return self
        stack = _stack()
        self._root = stack[0]._root if stack else _Root(self.name, self.frames)
        stack.append(self)
        self._child_ns = 0
        self._range = self._start = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._root.profiled = True
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        if self.device is not None and torch.device(self.device).type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self._on:
            return False
        ns = time.perf_counter_ns() - self._t0
        root = self._root
        stat = root.spans.get(self.name)
        if stat is None:
            stat = root.spans[self.name] = [0, 0, 0, None]
        stat[0] += 1
        stat[1] += ns
        stat[2] += ns - self._child_ns
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            if stat[3] is None:
                stat[3] = 0.0
            with _pending_lock:
                _pending.append((stat, self._start, end))
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child_ns += ns
        else:
            root.profiled = root.profiled or torch.autograd.profiler._is_profiler_enabled
            root.id = next(_ids)
            _calls.append(root)
            if _pending:
                _read_events(block=False)
        return False


class sync(span):
    """``with sync(name, n=1):`` around a read of a device value on the
    host (``n`` reads): the span ``sync.<name>`` and ``n`` added to the
    ``host_syncs`` counter."""

    __slots__ = ("_n",)

    def __init__(self, name: str, n: int = 1):
        super().__init__("sync." + name)
        self._n = n

    def __enter__(self):
        super().__enter__()
        if self._on:
            counters = self._root.counters
            counters[HOST_SYNCS] = counters.get(HOST_SYNCS, 0) + self._n
        return self


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's open root call
    (nothing is recorded outside one)."""
    if not enabled:
        return
    stack = _stack()
    if stack:
        counters = stack[0]._root.counters
        counters[name] = counters.get(name, 0) + n


def mark() -> int:
    """The id of the next root call to complete: ``calls(since=mark())``
    taken later returns the root calls completed in between."""
    return _calls[-1].id + 1 if _calls else 0


def calls(since: int = 0) -> List[dict]:
    """The completed root calls with ids from ``since``, newest last (at
    most ``MAX_CALLS``), each {"id", "name", "frames", "profiled", "spans":
    {name: {"count", "host_ns", "self_ns", "device_ms"}}, "counters"}; a
    span's ``device_ms`` is None unless it was given a CUDA device. Waits
    for the device spans' end events."""
    _read_events(block=True)
    return [
        {"id": r.id, "name": r.name, "frames": r.frames, "profiled": r.profiled,
         "spans": {k: {"count": c, "host_ns": h, "self_ns": s, "device_ms": d}
                   for k, (c, h, s, d) in r.spans.items()},
         "counters": dict(r.counters)}
        for r in list(_calls) if r.id >= since
    ]


def per_frame(records: List[dict], frames: int) -> dict:
    """Root calls summed and divided by ``frames``: {"frames", "spans":
    {name: {"count", "host_ms", "self_ms"[, "device_ms"]}} (ms a frame,
    count in all), "counters": {name: total}}."""
    spans: Dict[str, list] = {}
    counters: Dict[str, int] = {}
    for r in records:
        for k, v in r["spans"].items():
            acc = spans.setdefault(k, [0, 0, 0, None])
            acc[0] += v["count"]
            acc[1] += v["host_ns"]
            acc[2] += v["self_ns"]
            if v["device_ms"] is not None:
                acc[3] = (acc[3] or 0.0) + v["device_ms"]
        for k, v in r["counters"].items():
            counters[k] = counters.get(k, 0) + v
    f = max(frames, 1)
    out = {}
    for k, (c, h, s, d) in spans.items():
        out[k] = {"count": c, "host_ms": h / 1e6 / f, "self_ms": s / 1e6 / f}
        if d is not None:
            out[k]["device_ms"] = d / f
    return {"frames": frames, "spans": out, "counters": counters}
