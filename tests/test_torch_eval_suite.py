"""The port's acceptance suite against the JAX package on the CPU:

- ``eval/stats.py`` and ``eval/metrics.py`` on seeded inputs: equal to
  JAX's results exactly (both are numpy);
- ``run_all`` with the ORB and the pyramid ORB adapters on a small
  synthetic sequence (8 frames at scale 0.25, difficulty ``easy``):
  pass/fail flags, pair and step counts equal, every rate (repeatability,
  precision, recall, inlier ratio, tracking success) within 0.02 of
  JAX's. JAX's pyramid adapter runs under ``jax.jit`` here (its eager
  compile takes half a minute per batch shape on the CPU);
- the ``run-tests`` CLI: its JSON has the keys of JAX's ``run_all``
  result, the train/test overlap guard exits 1 as the JAX CLI does, and
  without ``--device cpu`` it asks for the card and raises without one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semantic_slam_master_tpu.cli import run_tests_cli as jrun_tests_cli
from semantic_slam_master_tpu.data import synthetic as jsynthetic
from semantic_slam_master_tpu.eval import frontend_tests as jft
from semantic_slam_master_tpu.eval import metrics as jmetrics
from semantic_slam_master_tpu.eval import stats as jstats
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch.cli import run_tests_cli
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.eval import frontend_tests as ft
from semantic_slam_master_tpu_torch.eval import metrics, stats
from semantic_slam_master_tpu_torch.utils import profiling

RATE_TOL = 0.02
KEYPOINTS = 200


def _same(a, b):
    """Equal results: dicts, lists and arrays compared element by element,
    floats exactly (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    for df in range(-1, 40):
        _same(stats.t_critical_975(df), jstats.t_critical_975(df))
    for n in (1, 2, 5, 12, 40):
        v = rng.normal(size=n)
        _same(stats.summarize(v), jstats.summarize(v))
    for n in (1, 3, 8, 12, 13, 30):
        a = np.round(rng.normal(size=n), 1)  # ties and zero differences
        b = np.round(a + rng.normal(scale=0.3, size=n), 1)
        b[: n // 4] = a[: n // 4]
        _same(stats.wilcoxon_signed_rank(a, b), jstats.wilcoxon_signed_rank(a, b))


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    K = np.array([[260.0, 0, 160], [0, 261.0, 120], [0, 0, 1]])
    a = rng.normal(scale=0.05, size=3)
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(a).as_matrix()
    T[:3, 3] = rng.normal(scale=0.05, size=3)
    k1 = rng.uniform([0, 0], [320, 240], size=(150, 2))
    k2 = k1 + rng.normal(scale=2.0, size=(150, 2))
    depth = rng.uniform(0.5, 4.0, size=(240, 320))
    depth[::7] = 0.0
    H = metrics.rotation_homography_np(K, T)
    _same(H, jmetrics.rotation_homography_np(K, T))
    _same(metrics.warp_points(H, k1), jmetrics.warp_points(H, k1))
    for bounds in (None, (320, 240), (100, 80)):
        _same(metrics.repeatability(k1, k2, H, bounds=bounds), jmetrics.repeatability(k1, k2, H, bounds=bounds))
    _same(metrics.repeatability(k1, k2[:0], H), jmetrics.repeatability(k1, k2[:0], H))
    warped, visible = metrics.reproject_with_depth(k1, depth, T, K)
    _same((warped, visible), jmetrics.reproject_with_depth(k1, depth, T, K))
    _same(metrics.nn_agreement(warped, k2, 3.0), jmetrics.nn_agreement(warped, k2, 3.0))
    gt = metrics.gt_matches_from_warp(warped, visible, k2, 3.0)
    _same(gt, jmetrics.gt_matches_from_warp(warped, visible, k2, 3.0))
    pred = np.stack([np.arange(150), rng.permutation(150)], 1)
    pred[:100, 1] = np.arange(100)
    _same(metrics.match_quality_from_warp(pred, gt, warped, k2), jmetrics.match_quality_from_warp(pred, gt, warped, k2))
    _same(metrics.match_quality_from_warp(pred[:0], gt, warped, k2),
          jmetrics.match_quality_from_warp(pred[:0], gt, warped, k2))
    gth = metrics.gt_matches_from_homography(k1, k2, H)
    _same(gth, jmetrics.gt_matches_from_homography(k1, k2, H))
    _same(metrics.match_quality(pred, gth, k1, k2, H), jmetrics.match_quality(pred, gth, k1, k2, H))
    counts = rng.integers(20, 90, size=17)
    for c in (counts, counts[:0]):
        _same(metrics.tracking_success(c, 50), jmetrics.tracking_success(c, 50))
    res = {"repeatability": 0.7, "precision": 0.5, "fps": 30.0, "other": 1.0}
    _same(metrics.check_targets(res), jmetrics.check_targets(res))
    _same(metrics.check_targets(res, {"fps": 60.0}), jmetrics.check_targets(res, {"fps": 60.0}))
    assert metrics.DEFAULT_TARGETS == jmetrics.DEFAULT_TARGETS
    assert ft.DIFFICULTY_PRESETS == jft.DIFFICULTY_PRESETS


def test_benchmark_stages_keys_match_jax():
    import torch

    x = torch.rand(64, 64)
    got = metrics.benchmark_stages({"matmul": (lambda a: a @ a, (x,))}, iters=8)
    ref = jmetrics.benchmark_stages({"matmul": (lambda a: a @ a, (jnp.asarray(x.numpy()),))}, iters=8)
    assert got.keys() == ref.keys() and got["matmul"].keys() == ref["matmul"].keys()
    assert got["total"].keys() == ref["total"].keys()
    assert got["matmul"]["iters"] == ref["matmul"]["iters"] == 8
    assert got["matmul"]["mean_ms"] > 0 and got["total"]["fps"] == pytest.approx(1e3 / got["total"]["mean_ms"])
    t = profiling.time_fn(lambda: x @ x, warmup=1, iters=5)
    assert t["iters"] == 5 and t["min_ms"] <= t["p50_ms"] <= t["max_ms"]


def _jax_pyramid_adapter():
    """JAX's pyramid adapter with ``extract_features`` under ``jax.jit``."""
    ref = jft.pyramid_orb_adapter(num_keypoints=KEYPOINTS)
    ext = jax.jit(lambda g: jtracking.extract_features(g, jnp.ones_like(g), num_keypoints=KEYPOINTS,
                                                       threshold=0.05, num_levels=4, scale_factor=1.2))

    def extract(rgb):
        f = ext(jnp.asarray(rgb) @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32))
        return {"xy": np.asarray(f.xy), "desc": np.asarray(f.desc), "valid": np.asarray(f.valid)}

    return jft.FrontendAdapter(ref.name, extract, ref.match, ref.stages)


@pytest.fixture(scope="module")
def suites():
    jseq = jsynthetic.make_sequence(num_frames=8, scale=0.25)
    pseq = synthetic.make_sequence(num_frames=8, scale=0.25)
    out = {}
    for name, jad, pad in (
        ("orb", jft.orb_adapter(num_keypoints=KEYPOINTS), ft.orb_adapter(num_keypoints=KEYPOINTS, device="cpu")),
        ("pyramid", _jax_pyramid_adapter(), ft.pyramid_orb_adapter(num_keypoints=KEYPOINTS, device="cpu")),
    ):
        out[name] = (jft.run_all(jseq, jad, "easy", with_performance=False),
                     ft.run_all(pseq, pad, "easy", with_performance=name == "orb"))
    return out


RATES = {"repeatability": ("mean_repeatability", "median_repeatability"),
         "descriptor_quality": ("precision", "recall", "f1", "inlier_ratio"),
         "tracking": ("success_rate",)}
COUNTS = {"repeatability": ("num_pairs", "spacing"), "descriptor_quality": ("num_pairs",),
          "tracking": ("num_steps", "spacing")}


@pytest.mark.parametrize("adapter", ["orb", "pyramid"])
def test_run_all_matches_jax(suites, adapter):
    ref, got = suites[adapter]
    assert got["frontend"] == ref["frontend"] and got["difficulty"] == ref["difficulty"]
    for test in RATES:
        rs = ref[test] if isinstance(ref[test], list) else [ref[test]]
        gs = got[test] if isinstance(got[test], list) else [got[test]]
        assert len(gs) == len(rs)
        for g, r in zip(gs, rs):
            assert g["passed"] == r["passed"], (test, g, r)
            for k in COUNTS[test]:
                assert g[k] == r[k], (test, k)
            for k in RATES[test]:
                assert abs(g[k] - r[k]) <= RATE_TOL, (test, k, g[k], r[k])
            assert r[RATES[test][0]] > 0.5  # the comparison is not vacuous
    if adapter == "orb":
        perf = got["performance"]
        assert perf["test"] == "performance" and perf["fps"] > 0
        assert set(perf["stages"]) == {"fast_detect", "orb_describe", "hamming_match", "total"}


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items() if k != "per_pair"}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


def test_run_tests_cli_json_has_jax_keys(suites, tmp_path):
    out = tmp_path / "results.json"
    rc = run_tests_cli.main(["--synthetic", "--synthetic-frames", "6", "--difficulty", "easy", "--no-performance",
                             "--device", "cpu", "--output", str(out)])
    res = json.loads(out.read_text())
    assert list(res) == ["synthetic_room"]
    r = res["synthetic_room"]
    assert rc == (0 if r["all_passed"] else 1)
    assert _keys(r) == _keys(suites["pyramid"][0])
    assert "per_pair" not in json.dumps(res)


def test_overlap_guard_exits_1(tmp_path, capsys):
    argv = ["--sequences", "rgbd_dataset_freiburg1_desk", "--train-sequences", "rgbd_dataset_freiburg1_desk",
            "--data-root", str(tmp_path), "--output", str(tmp_path / "r.json")]
    assert run_tests_cli.main(argv + ["--device", "cpu"]) == jrun_tests_cli.main(argv) == 1
    assert "Pass --allow-train-overlap" in capsys.readouterr().err
    # With the override the guard lets it through; no sequence is on disk, so it stops there (exit 1).
    assert run_tests_cli.main(argv + ["--allow-train-overlap", "--device", "cpu"]) == 1
    assert "no sequences available" in capsys.readouterr().err
    assert not (tmp_path / "r.json").exists()


def test_run_tests_defaults_to_cuda_and_raises_without_it(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_tests_cli.main(["--synthetic", "--output", str(tmp_path / "r.json")])
