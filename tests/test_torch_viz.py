"""Port parity of ``viz/`` against the JAX package on the CPU: the numbers
each plot returns or is built from (saliency statistics, the Sobel edge
map, match qualities and filters, the per-spacing match counts) and the
PNG each writes.

Tolerances, and why: the edge map is three small float convolutions in
each library's own order, and the statistics are numpy reductions of it
and of the same saliency map, so both agree within 1e-5; match counts,
filters and the ORB matches behind them (bit-exact on the CPU) are held
exactly. The PNG tests need ``matplotlib`` and skip where it is absent.
"""

import json

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.viz import matches as jmatches
from semantic_slam_master_tpu.viz import saliency as jsaliency
from semantic_slam_master_tpu_torch.cli import visualize_cli
from semantic_slam_master_tpu_torch.viz import matches as tmatches
from semantic_slam_master_tpu_torch.viz import saliency as tsaliency
from semantic_slam_master_tpu_torch.viz import test_dashboard, trajectory


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (six test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.make_sequence(num_frames=4, scale=0.25)
    return [seq.frame(i)["rgb"].astype(np.float32) for i in range(4)]


@pytest.fixture
def plt_available():
    pytest.importorskip("matplotlib")


def test_edge_map_matches_jax(frames):
    np.testing.assert_allclose(tsaliency._edge_map(frames[0]), jsaliency._edge_map(frames[0]), rtol=0, atol=1e-5)


def test_saliency_dashboard_stats_and_png(frames, tmp_path, plt_available):
    rgb = frames[0]
    sal, kpts = visualize_cli.saliency_map(rgb, torch.device("cpu"))
    ref = jsaliency.saliency_dashboard(rgb, sal, kpts, tmp_path / "jax.png")
    got = tsaliency.saliency_dashboard(rgb, sal, kpts, tmp_path / "port.png")
    assert set(got) == set(ref) == {"mean_saliency", "max_saliency", "saliency_variance",
                                    "edge_saliency_correlation"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
    assert (tmp_path / "port.png").stat().st_size > 0


def test_quality_and_filters_match_jax():
    rng = np.random.default_rng(0)
    sim = rng.uniform(0, 1, 200).astype(np.float32)
    sal = rng.uniform(0, 1, 200).astype(np.float32)
    sim[:3], sal[:3] = [0.5, 0.49, 1.0], [0.1, 0.2, 0.0999]
    np.testing.assert_array_equal(tmatches.combined_quality(sim, sal), jmatches.combined_quality(sim, sal))
    for kw in ({}, {"min_similarity": 0.3, "min_saliency": 0.5}):
        np.testing.assert_array_equal(tmatches.filter_matches(sim, sal, **kw), jmatches.filter_matches(sim, sal, **kw))


def _jax_orb_extract_and_match():
    from semantic_slam_master_tpu.cli import visualize_cli as jvisualize_cli

    return jvisualize_cli._orb_extract_and_match()


def test_sequence_match_grid_counts_match_jax(frames, tmp_path, plt_available):
    """Per-spacing match counts of the port's ORB matcher equal JAX's."""
    spacings = (1, 2, 3, 9)  # 9 is past the 4 frames and left out, as in JAX
    ref = jmatches.sequence_match_grid(frames, _jax_orb_extract_and_match(), spacings, tmp_path / "jax.png")
    fn = visualize_cli.orb_extract_and_match(torch.device("cpu"))
    got = tmatches.sequence_match_grid(frames, fn, spacings, tmp_path / "seq.png")
    assert got == ref and set(got) == {1, 2, 3} and min(got.values()) > 0
    assert (tmp_path / "seq.png").stat().st_size > 0


def test_orb_extract_and_match_equals_jax(frames):
    k1, k2, m, sims = visualize_cli.orb_extract_and_match(torch.device("cpu"))(frames[0], frames[1])
    j1, j2, jm, jsims = _jax_orb_extract_and_match()(frames[0], frames[1])
    np.testing.assert_array_equal(k1, j1)
    np.testing.assert_array_equal(k2, j2)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(sims, jsims)


def test_draw_matches_png(frames, tmp_path, plt_available):
    k1, k2, m, sims = visualize_cli.orb_extract_and_match(torch.device("cpu"))(frames[0], frames[1])
    out = tmp_path / "sub" / "matches.png"
    tmatches.draw_matches(frames[0], frames[1], k1, k2, m, sims, out, title="t")
    assert out.stat().st_size > 0


def test_trajectory_plot_png(tmp_path, plt_available):
    seq = synthetic.make_sequence(num_frames=6, scale=0.25)
    est = seq.poses_wc.copy()
    est[:, :3, 3] += 0.01
    out = tmp_path / "plots" / "s_trajectory.png"
    trajectory.plot_trajectory_comparison(seq.poses_wc, est, out, title="s")
    assert out.stat().st_size > 0


def test_acceptance_dashboard_png(tmp_path, plt_available):
    """A run_all result with a performance section, and one without."""
    rep = [{"spacing": 1, "mean_repeatability": 0.8, "target": 0.7},
           {"spacing": 5, "mean_repeatability": 0.5, "target": 0.7}]
    tr = [{"spacing": 1, "success_rate": 1.0, "target": 0.9}]
    dq = {"precision": 0.8, "recall": 0.4, "f1": 0.5, "inlier_ratio": 0.9}
    perf = {"stages": {"fast_detect": {"mean_ms": 1.5}, "orb_describe": {"mean_ms": 2.0},
                       "total": {"mean_ms": 3.5}}, "fps": 285.7}
    for name, res in (("full", {"repeatability": rep, "tracking": tr, "descriptor_quality": dq,
                                "performance": perf}),
                      ("bare", {"repeatability": rep, "tracking": tr, "descriptor_quality": dq})):
        out = test_dashboard.acceptance_dashboard(json.loads(json.dumps(res)), tmp_path / f"{name}.png", "seq")
        assert out == str(tmp_path / f"{name}.png") and (tmp_path / f"{name}.png").stat().st_size > 0
