"""The port's recorder (``utils/profiling.py``): spans, self time, root
calls, the bound, counters and syncs; its ranges in a CPU profiler trace
(host ops, not user annotations); results bit-equal with recording on and off; and the
counters the SLAM loop and the frame staging record, against what the
output says they should be."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.slam import system, tracking
from semantic_slam_master_tpu_torch.utils import profiling


def _last(name):
    return next(c for c in reversed(profiling.calls()) if c["name"] == name)


@pytest.fixture
def recording():
    """Recording switched on for the test and restored after it."""
    was = profiling.enabled
    profiling.enabled = True
    yield
    profiling.enabled = was


def test_spans_nest_into_one_root_with_self_time_and_counters(recording):
    with profiling.span("test.root", frames=4):
        with profiling.span("a"):
            time.sleep(0.002)
            with profiling.span("b"):
                time.sleep(0.003)
            profiling.count("things", 2)
        with profiling.span("a"):
            pass
        with profiling.sync("site", 3):
            pass
        profiling.count("things")
    c = _last("test.root")
    assert c["frames"] == 4 and not c["profiled"]
    s = c["spans"]
    assert set(s) == {"test.root", "a", "b", "sync.site"}
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1 and s["test.root"]["count"] == 1
    assert s["b"]["host_ns"] >= 3e6 and s["a"]["host_ns"] >= 5e6
    assert s["a"]["self_ns"] == s["a"]["host_ns"] - s["b"]["host_ns"]
    assert s["test.root"]["self_ns"] == s["test.root"]["host_ns"] - s["a"]["host_ns"] - s["sync.site"]["host_ns"]
    assert s["test.root"]["host_ns"] >= s["a"]["host_ns"] + s["sync.site"]["host_ns"]
    assert all(v["device_ms"] is None for v in s.values())  # no CUDA device given
    assert c["counters"] == {"things": 3, profiling.HOST_SYNCS: 3}


def test_roots_ids_bound_and_counts_outside_a_root(recording):
    first = profiling.mark()
    profiling.count("nowhere")  # no open root: recorded nowhere
    for i in range(3):
        with profiling.span("test.solo", frames=i):
            pass
    got = profiling.calls(since=first)
    assert [c["name"] for c in got] == ["test.solo"] * 3
    assert [c["frames"] for c in got] == [0, 1, 2]
    assert [c["id"] for c in got] == list(range(first, first + 3))
    assert all(c["counters"] == {} for c in got)
    assert profiling.mark() == first + 3
    for _ in range(profiling.MAX_CALLS + 5):
        with profiling.span("test.flood"):
            pass
    everything = profiling.calls()
    assert len(everything) == profiling.MAX_CALLS
    assert everything[-1]["id"] == profiling.mark() - 1
    assert profiling.calls(since=first) == everything  # the oldest ones are gone


def test_a_span_that_raises_is_still_recorded(recording):
    with pytest.raises(KeyError), profiling.span("test.raises"):
        with profiling.span("inner"):
            raise KeyError("recorded all the same")
    s = _last("test.raises")["spans"]
    assert s["inner"]["count"] == 1 and s["test.raises"]["count"] == 1
    with profiling.span("test.after"):  # the thread's stack is empty again
        pass
    assert set(_last("test.after")["spans"]) == {"test.after"}


def test_switched_off_records_nothing(recording):
    first = profiling.mark()
    profiling.enabled = False
    with profiling.span("test.off"):
        with profiling.sync("x"):
            profiling.count("y")
    assert profiling.calls(since=first) == []


def test_per_frame_sums_root_calls(recording):
    first = profiling.mark()
    for _ in range(2):
        with profiling.span("test.pf", frames=5):
            with profiling.span("a"):
                pass
            profiling.count("n", 4)
    got = profiling.per_frame(profiling.calls(since=first), 10)
    assert got["frames"] == 10 and got["counters"] == {"n": 8}
    assert set(got["spans"]) == {"test.pf", "a"}
    assert got["spans"]["a"]["count"] == 2
    a = [c["spans"]["a"]["host_ns"] for c in profiling.calls(since=first)]
    assert got["spans"]["a"]["host_ms"] == pytest.approx(sum(a) / 1e6 / 10)
    assert "device_ms" not in got["spans"]["a"]


def test_ranges_appear_in_the_profiler_trace_only_while_it_runs(recording):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.profiled"):
            with profiling.span("test.inside"):
                torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert "test.profiled" in names and "test.inside" in names
    assert _last("test.profiled")["profiled"]
    inside = next(e for e in prof.events() if e.name == "test.inside")
    outer = next(e for e in prof.events() if e.name == "test.profiled")
    assert outer.time_range.start <= inside.time_range.start <= inside.time_range.end <= outer.time_range.end
    # A host op: a user annotation would also get a copy on the device's
    # timeline, which a reader of the trace takes for device work.
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() in ("test.profiled", "test.inside")]
    assert len(ranges) == 2 and not any(e.is_user_annotation() for e in ranges)
    with profile(activities=[ProfilerActivity.CPU]) as prof2:
        torch.ones(8).sum()
    with profiling.span("test.unprofiled"):
        torch.ones(8).sum()
    assert not _last("test.unprofiled")["profiled"]
    assert "test.unprofiled" not in [e.name for e in prof2.events()]


# --- the SLAM loop ---------------------------------------------------------

F = 10


@pytest.fixture(scope="module")
def orb_run():
    seq = synthetic.make_sequence(num_frames=F, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    cfg = system.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=2)
    feats = run_slam_cli.features_for_frames(gray, depth, 300, torch.device("cpu"))
    u = torch.rand((F, cfg.num_hypotheses, 3), generator=torch.Generator().manual_seed(3))
    return seq, feats, u, cfg


def _slam(orb_run):
    seq, feats, u, cfg = orb_run
    return system.run_slam(u, feats, seq.cam, cfg)


def test_run_slam_is_bit_equal_with_recording_on_and_off(orb_run, recording):
    first = profiling.mark()
    on = _slam(orb_run)
    assert [c["name"] for c in profiling.calls(since=first)] == ["slam.run"]
    profiling.enabled = False
    off = _slam(orb_run)
    assert profiling.calls(since=first + 1) == []
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_slam_counters_follow_the_output(orb_run, recording):
    cfg = orb_run[3]
    out = _slam(orb_run)
    c = _last("slam.run")
    kf = int(out.is_keyframe[1:].sum())
    assert kf >= 1
    assert c["frames"] == F
    assert c["counters"]["keyframes"] == kf
    # Per tracked frame: the best hypothesis's pose, support and inlier
    # count, the keyframe test, and the constant row of 13 poses built
    # (the 64 Kabsch fits in one, 10 Gauss-Newton steps, 2 inverses). Per
    # map update (the bootstrap and each keyframe): the new landmarks'
    # count, two mask reads in each of ten scatters, the window slot's
    # flag. Per keyframe: BA's damping and one pose row per iteration.
    # Once a call: the keyframe flags' copy.
    tracked, updates = F - 1, 1 + kf
    assert c["counters"][profiling.HOST_SYNCS] == 17 * tracked + 22 * updates + (1 + cfg.ba_iters) * kf + 1
    s = c["spans"]
    for name in ("slam.match", "slam.ransac", "slam.refine", "sync.ransac.best_pose", "sync.refine.best_support",
                 "sync.refine.best_inliers", "sync.step.need_kf"):
        assert s[name]["count"] == tracked, name
    assert s["slam.map"]["count"] == updates and s["sync.map.num_new"]["count"] == updates
    assert s["sync.map.scatter"]["count"] == 10 * updates and s["sync.map.kf_used"]["count"] == updates
    assert s["sync.lie.make_pose"]["count"] == 13 * tracked + cfg.ba_iters * kf
    assert s["sync.ba.lambda"]["count"] == kf and s["sync.steps.is_keyframe"]["count"] == 1
    assert s["slam.ba"]["count"] == kf and s["slam.bootstrap"]["count"] == 1 and s["slam.steps"]["count"] == 1
    parts = sum(s[k]["host_ns"] for k in ("slam.match", "slam.ransac", "slam.refine", "slam.map", "slam.ba"))
    assert parts <= s["slam.run"]["host_ns"]


def test_live_steps_are_roots_of_their_own(orb_run, recording):
    seq, feats, u, cfg = orb_run
    first = profiling.mark()
    state = system.bootstrap_map(system.frame(feats, 0), seq.cam, cfg)
    carry = (state, torch.eye(4), 0)
    for f in range(1, 3):
        one = tracking.FrameFeatures(*[x[f : f + 1] for x in feats])
        carry, _ = system.run_slam_steps(u[f : f + 1], one, seq.cam, cfg, *carry)
    got = profiling.calls(since=first)
    assert [(c["name"], c["frames"]) for c in got] == [("slam.bootstrap", 1), ("slam.steps", 1), ("slam.steps", 1)]
    assert got[0]["counters"][profiling.HOST_SYNCS] == 22
    assert "slam.map" in got[0]["spans"]


# --- the frontends ------------------------------------------------------------

def test_learned_features_are_bit_equal_with_recording_on_and_off(recording):
    model = tfrontend.tiny_frontend(subpatch_refine=True, dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.5, 3, (2, 64, 96)).astype(np.float32))
    with profiling.span("test.learned", frames=2):
        on = tracking.extract_learned_features(model, rgb, depth)
    spans = _last("test.learned")["spans"]
    assert spans["frontend.backbone"]["count"] == spans["frontend.heads"]["count"] == 1
    assert spans["frontend.backbone"]["device_ms"] is None  # events only on a CUDA device
    profiling.enabled = False
    off = tracking.extract_learned_features(model, rgb, depth)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_staging_counts_the_bytes_copied_to_another_device(monkeypatch, recording):
    """The frames padded to whole chunks, each chunk copied from the host:
    ``h2d_bytes`` is the arrays' bytes a frame times the padded frames."""
    n, chunk, h, w = 10, 4, 6, 5
    rgb = np.zeros((n, h, w, 3), np.float32)
    depth = np.zeros((n, h, w), np.float32)
    seen = []

    def fake_extract(model, rgb_c, depth_c, weight_map=None):
        seen.append((rgb_c.device.type, tuple(rgb_c.shape), depth_c.device.type))
        z = torch.zeros(rgb_c.shape[0], 1)
        return tracking.FrameFeatures(*([z] * len(tracking.FrameFeatures._fields)))

    monkeypatch.setattr(tracking, "extract_learned_features", fake_extract)
    run_slam_cli.learned_features_for_frames(None, rgb, depth, torch.device("meta"), chunk=chunk)
    c = _last("frontend.features")
    padded = 12
    assert seen == [("meta", (chunk, h, w, 3), "meta")] * (padded // chunk)
    assert c["frames"] == n
    assert c["counters"]["h2d_bytes"] == padded * (rgb[0].nbytes + depth[0].nbytes)
    assert c["counters"].get("h2d_pinned_bytes", 0) == 0
    assert c["spans"]["stage.copy"]["count"] == 2 * padded // chunk
    assert c["spans"]["stage.pad"]["count"] == 1
    # No copy to record when the frames stay on their device.
    run_slam_cli.learned_features_for_frames(None, rgb, depth, torch.device("cpu"), chunk=chunk)
    c = _last("frontend.features")
    assert "stage.copy" not in c["spans"] and "h2d_bytes" not in c["counters"]
