"""Tracing of one pass with ``torch.profiler`` and its reduction.

The benchmark records its own spans around the calls into each layer of
the port (``Tracer.stage``), with the device synchronised at each span's
edges so that every kernel a span launches runs inside it. In a
``--trace 1`` window the first pass times the spans with CUDA events and
the second runs under the profiler; the reduction reads device-op
intervals, kernels by name and stage, and the host op behind each idle
gap from the profiler's events.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

STAGE_PREFIX = "bench.stage:"
TOP = 10


def busy_seconds(intervals) -> float:
    """Union of (start_ns, end_ns) device intervals, in seconds.

    Copied from ``profile_port.py::busy_ms`` (the device's busy time as
    the union of its kernel intervals), on kineto's nanosecond events."""
    spans = sorted((s, e) for s, e in intervals if e > s)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary(NamedTuple):
    window_s: float  # host clock over the profiled pass
    busy_s: float  # union of device-op intervals in the profiled pass
    span_window_s: float  # host clock over the span pass (no profiler)
    stage_ms: dict  # stage -> device ms between the span's CUDA events (span pass)
    stage_frames: dict  # stage -> frames the span's calls handled
    stage_kernels: dict  # stage -> kernels launched inside the stage (profiled pass)
    kernel_s: dict  # device-op name -> seconds (profiled pass)
    kernel_n: dict  # device-op name -> count
    device_ops: list  # [[name, seconds]] the TOP longest in total
    idle_gaps: list  # [[stage/host op, seconds]] the TOP longest gaps


class Tracer:
    """With tracing on, the first pass handed to ``traced_pass`` is a span
    pass: ``stage`` records CUDA events around each call, with no
    profiler, so its times carry no profiler overhead. The second is the
    profiled pass: the same calls under ``torch.profiler``, each inside a
    ``record_function`` range that attributes kernels to stages. Outside
    these two passes, or with tracing off, both are no-ops, so the drives
    call them unconditionally."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.phase = "spans" if enabled else "done"
        self.current = None
        self.summary: TraceSummary | None = None
        self._events = []  # (stage, start event, end event, frames)
        self._span_window_s = 0.0

    @property
    def done(self) -> bool:
        return self.phase == "done"

    @contextlib.contextmanager
    def traced_pass(self):
        if self.phase == "done" or self.current is not None:
            yield
            return
        phase, prof = self.phase, None
        torch.cuda.synchronize(self.device)
        if phase == "profile":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        self.current = phase
        t0 = time.perf_counter()
        try:
            yield
            torch.cuda.synchronize(self.device)
        finally:
            window_s = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
            self.current = None
        if phase == "spans":
            self._span_window_s = window_s
            self.phase = "profile"
        else:
            self.summary = reduce(prof, window_s, self._span_window_s, self._events)
            self.phase = "done"

    @contextlib.contextmanager
    def stage(self, name: str, frames: int):
        if self.current is None:
            yield
            return
        torch.cuda.synchronize(self.device)
        if self.current == "profile":
            with torch.profiler.record_function(STAGE_PREFIX + name):
                yield
                torch.cuda.synchronize(self.device)
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        torch.cuda.synchronize(self.device)
        self._events.append((name, start, end, frames))


def _is_kernel(name: str, kind: str) -> bool:
    if kind:
        return kind == "kernel"
    return not name.startswith(("Memcpy", "Memset"))


def reduce(prof, window_s: float, span_window_s: float, stage_events) -> TraceSummary:
    stage_ms, stage_frames = defaultdict(float), defaultdict(int)
    for name, start, end, frames in stage_events:
        stage_ms[name] += start.elapsed_time(end)
        stage_frames[name] += frames
    dev, ranges, cpu = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        d = e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(STAGE_PREFIX):
                continue  # the GPU side of a benchmark span, not a device op
            kind = ""
            try:
                kind = str(e.activity_type()).lower()
                if "annotation" in kind:
                    continue
                kind = "kernel" if "kernel" in kind else ("memory" if "mem" in kind else kind)
            except (AttributeError, RuntimeError):
                kind = ""
            dev.append((s, s + d, name, _is_kernel(name, kind)))
        elif name.startswith(STAGE_PREFIX):
            ranges.append((s, s + d, name[len(STAGE_PREFIX):]))
        else:
            cpu.append((s, s + d, name))
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    for s, e, name, _ in dev:
        kernel_s[name] += (e - s) / 1e9
        kernel_n[name] += 1
    stage_kernels = defaultdict(int)
    starts = np.array([s for s, _, _, k in dev if k], dtype=np.int64)
    for rs, re_, name in ranges:
        stage_kernels[name] += int(((starts >= rs) & (starts <= re_)).sum())
    device_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=window_s,
        span_window_s=span_window_s,
        busy_s=busy_seconds([(s, e) for s, e, _, _ in dev]),
        stage_ms=dict(stage_ms),
        stage_frames=dict(stage_frames),
        stage_kernels=dict(stage_kernels),
        kernel_s=dict(kernel_s),
        kernel_n=dict(kernel_n),
        device_ops=[[n[:160], v] for n, v in device_ops],
        idle_gaps=_idle_gaps([(s, e) for s, e, _, _ in dev], ranges, cpu),
    )


def _idle_gaps(dev, ranges, cpu):
    """The TOP longest gaps between device ops, each named by the stage
    span and the innermost host op active at its midpoint."""
    m = merged(dev)
    gaps = sorted(((m[i + 1][0] - m[i][1], m[i][1], m[i + 1][0]) for i in range(len(m) - 1)), reverse=True)[:TOP]
    if not gaps:
        return []
    cs = np.array([c[0] for c in cpu], dtype=np.int64)
    ce = np.array([c[1] for c in cpu], dtype=np.int64)
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        stage = next((n for rs, re_, n in ranges if rs <= mid <= re_), "none")
        hit = np.nonzero((cs <= mid) & (ce >= mid))[0]
        op = cpu[hit[np.argmax(cs[hit])]][2] if len(hit) else "idle host"
        out.append([f"{stage}/{op}"[:160], length / 1e9])
    return out
