"""``harness/program_trace.py``: root calls grouped into passes, profiled
passes dropped, the median over passes, and None where the port records
nothing or too few passes."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH)]

from harness import program_trace  # noqa: E402


def call(name, frames, spans=None, counters=None, profiled=False):
    """A root call as the port's ``profiling.calls()`` returns it; spans
    given as {name: (count, host_ms[, device_ms])}."""
    s = {name: (1, sum(v[1] for v in (spans or {}).values()) + 1.0)}
    s.update(spans or {})
    return {"id": 0, "name": name, "frames": frames, "profiled": profiled, "counters": dict(counters or {}),
            "spans": {k: {"count": v[0], "host_ns": int(v[1] * 1e6), "self_ns": 0,
                          "device_ms": v[2] if len(v) > 2 else None} for k, v in s.items()}}


def ctx(drive):
    return SimpleNamespace(traffic={"drive": drive})


def slam_pass(match_ms, syncs, profiled=False):
    return [call("segmenter.weights", 60, {"stage.copy": (8, 6.0)}, {"h2d_bytes": 600}, profiled),
            call("frontend.features", 60, {"stage.pad": (1, 60.0), "stage.copy": (16, 12.0),
                                           "frontend.backbone": (8, 1.0, 120.0)}, {"h2d_bytes": 1200}, profiled),
            call("slam.run", 60, {"slam.match": (59, match_ms * 60), "slam.bootstrap": (1, 1.0),
                                  "sync.step.need_kf": (59, 3.0)}, {"host_syncs": syncs, "keyframes": 5}, profiled)]


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(program_trace, "records", lambda: calls)
    return calls


def test_slam_passes_pair_the_kinds_from_the_newest_and_drop_profiled(recorded):
    # A frontend call left over from before the window (no loop after it),
    # then a warm pass, a profiled pass and three more.
    recorded.append(call("frontend.features", 60))
    for i, (m, profiled) in enumerate([(9.0, False), (1.0, True), (2.0, False), (3.0, False), (4.0, False)]):
        recorded.extend(slam_pass(m, 300 + i, profiled))
    got = program_trace.passes(recorded, program_trace.STAGING_ROOTS)
    assert len(got) == 4  # five complete passes, the profiled one dropped
    assert all([c["name"] for c in g] == ["segmenter.weights", "frontend.features"] for g, _ in got)
    assert [f for _, f in got] == [60] * 4
    assert program_trace.loop_span_ms(ctx("slam"), "slam.match") == pytest.approx(3.5)  # median of 9, 2, 3, 4
    assert program_trace.loop_counter_per_frame(ctx("slam"), "host_syncs") == pytest.approx(302.5 / 60)  # median of 300, 302, 303, 304
    assert program_trace.keyframe_share(ctx("slam")) == pytest.approx(6 / 60)
    assert program_trace.sync_wait_ms(ctx("slam")) == pytest.approx(3.0 / 60)
    assert program_trace.staging_ms(ctx("slam")) == pytest.approx(78.0 / 60)
    assert program_trace.h2d_mb_per_frame(ctx("slam")) == pytest.approx(1800 / 1e6 / 60)
    assert program_trace.frontend_device_ms(ctx("frontend"), "frontend.backbone") == pytest.approx(2.0)


def test_live_passes_run_from_one_bootstrap_to_the_next(recorded):
    recorded.append(call("slam.steps", 1, {"slam.match": (1, 50.0)}))  # a pass cut by the bound: no bootstrap
    for match_ms, profiled in [(1.0, False), (5.0, True), (2.0, False), (3.0, False)]:
        recorded.append(call("slam.bootstrap", 1, {"slam.map": (1, 0.5)}, {"host_syncs": 21}, profiled))
        recorded.append(call("frontend.other", None))  # other roots in between are not the loop's
        recorded.extend(call("slam.steps", 1, {"slam.match": (1, match_ms)}, {"host_syncs": 5}, profiled)
                        for _ in range(3))
    got = program_trace.passes(recorded, program_trace.LIVE_ROOTS)
    assert [[c["name"] for c in g] for g, _ in got] == [["slam.bootstrap"] + ["slam.steps"] * 3] * 3
    assert [f for _, f in got] == [4, 4, 4]
    assert program_trace.loop_span_ms(ctx("live"), "slam.match") == pytest.approx(2.0 * 3 / 4)
    assert program_trace.loop_span_ms(ctx("live"), "slam.map") == pytest.approx(0.5 / 4)
    assert program_trace.loop_counter_per_frame(ctx("live"), "host_syncs") == pytest.approx(36 / 4)
    assert program_trace.keyframe_share(ctx("live")) == pytest.approx(1 / 4)


def test_none_without_a_recorder_or_with_too_few_passes(recorded, monkeypatch):
    for m in (1.0, 2.0):
        recorded.extend(slam_pass(m, 300))
    assert program_trace.loop_span_ms(ctx("slam"), "slam.match") is None  # two passes
    recorded.extend(slam_pass(3.0, 300))
    assert program_trace.loop_span_ms(ctx("slam"), "slam.match") == pytest.approx(2.0)
    assert program_trace.loop_span_ms(ctx("slam"), "slam.ba") == 0.0  # no keyframe BA in these passes
    assert program_trace.frontend_device_ms(ctx("slam"), "frontend.heads") is None  # never recorded
    monkeypatch.setattr(program_trace, "records", lambda: None)
    assert program_trace.loop_span_ms(ctx("slam"), "slam.match") is None


def test_records_reads_the_port_or_gives_none(monkeypatch):
    from semantic_slam_master_tpu_torch.utils import profiling

    assert isinstance(program_trace.records(), list)
    monkeypatch.delattr(profiling, "calls")  # a port from before the recorder
    assert program_trace.records() is None
