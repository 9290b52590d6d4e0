"""The port's own recorder (``utils/profiling.py`` in the port), read after
the window: the spans and counters the program records inside its calls,
grouped into passes.

A pass is, in the ``slam`` and ``frontend`` drives, one root call of each
kind read (``segmenter.weights``, ``frontend.features``, ``slam.run``),
the kinds aligned on their newest call; in the ``live`` drive, every
``slam.bootstrap`` and ``slam.steps`` root call from one ``slam.bootstrap``
up to the next. Passes recorded while the profiler ran are dropped. A
metric is the median over the passes of a span's time (or a counter) in
the pass over the pass's frames, so the set-up's warm pass and the span
pass are outliers the median ignores. It is None with fewer than
``MIN_PASSES`` passes, and for a port that records nothing.
"""

from __future__ import annotations

import statistics

MIN_PASSES = 3
LOOP_ROOTS = ("slam.run",)
LIVE_ROOTS = ("slam.bootstrap", "slam.steps")
FRONTEND_ROOTS = ("frontend.features",)
STAGING_ROOTS = ("segmenter.weights", "frontend.features")
LOOP_SPANS = ("slam.match", "slam.ransac", "slam.refine", "slam.map", "slam.ba")


def records():
    """The port's completed root calls, oldest first, or None where the
    port has no recorder."""
    from semantic_slam_master_tpu_torch.utils import profiling

    calls = getattr(profiling, "calls", None)
    return calls() if calls is not None else None


def passes(calls, kinds) -> list:
    """[(root calls, frames)] of the passes over the root calls named in
    ``kinds`` (``LIVE_ROOTS``: grouped from one ``slam.bootstrap`` to the
    next), oldest first, those recorded under the profiler left out."""
    if tuple(kinds) == LIVE_ROOTS:
        groups = []
        for c in calls:
            if c["name"] == "slam.bootstrap":
                groups.append([c])
            elif c["name"] == "slam.steps" and groups:
                groups[-1].append(c)
        frames = [sum(c["frames"] or 0 for c in g) for g in groups]
    else:
        by_kind = [b for b in ([c for c in calls if c["name"] == k] for k in kinds) if b]
        n = min((len(b) for b in by_kind), default=0)
        groups = [[b[len(b) - n + i] for b in by_kind] for i in range(n)]
        frames = [g[0]["frames"] or 0 for g in groups]
    return [(g, f) for g, f in zip(groups, frames) if f > 0 and not any(c["profiled"] for c in g)]


def _median(kinds, value):
    """Median over the passes of ``value(root calls) / frames``; None where
    the port records nothing, or with fewer than ``MIN_PASSES`` passes
    for which ``value`` is not None."""
    calls = records()
    if calls is None:
        return None
    got = [v / f for g, f in passes(calls, kinds) for v in [value(g)] if v is not None]
    return statistics.median(got) if len(got) >= MIN_PASSES else None


def span_total(roots, names, field="host_ns"):
    """Sum of ``field`` over the spans named in ``names`` (or whose name
    ``names`` accepts, when it is callable) in ``roots``; None where a
    device field was never recorded."""
    total, seen = 0.0, False
    for r in roots:
        for k, v in r["spans"].items():
            if (names(k) if callable(names) else k in names) and v[field] is not None:
                total += v[field]
                seen = True
    return total if seen or field == "host_ns" else None


def counter_total(roots, name) -> int:
    return sum(r["counters"].get(name, 0) for r in roots)


def loop_kinds(ctx):
    return LIVE_ROOTS if ctx.traffic["drive"] == "live" else LOOP_ROOTS


def loop_span_ms(ctx, name: str):
    """Host ms a frame in the SLAM loop's span ``name``."""
    return _median(loop_kinds(ctx), lambda g: span_total(g, (name,)) / 1e6)


def sync_wait_ms(ctx):
    """Host ms a frame inside the loop's ``sync.*`` spans."""
    return _median(loop_kinds(ctx), lambda g: span_total(g, lambda k: k.startswith("sync.")) / 1e6)


def loop_counter_per_frame(ctx, name: str):
    return _median(loop_kinds(ctx), lambda g: counter_total(g, name))


def keyframe_share(ctx):
    """Keyframes a frame, the bootstrap frame counted as ``is_keyframe``
    counts it: tracked keyframes (``keyframes``) plus ``slam.bootstrap``
    calls."""
    return _median(loop_kinds(ctx),
                   lambda g: counter_total(g, "keyframes") + sum(
                       r["spans"].get("slam.bootstrap", {"count": 0})["count"] for r in g))


def frontend_device_ms(ctx, name: str):
    """Device ms a frame between the CUDA events of the learned frontend's
    span ``name``."""
    return _median(FRONTEND_ROOTS, lambda g: span_total(g, (name,), "device_ms"))


def staging_ms(ctx):
    """Host ms a frame padding the frames and copying them to the device,
    in the segmenter's and the frontend's calls together."""
    return _median(STAGING_ROOTS, lambda g: span_total(g, ("stage.pad", "stage.copy")) / 1e6)


def h2d_mb_per_frame(ctx):
    """MB (1e6 bytes) a frame copied from the host to the device by the
    segmenter's and the frontend's calls."""
    return _median(STAGING_ROOTS, lambda g: counter_total(g, "h2d_bytes") / 1e6)

