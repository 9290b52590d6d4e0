"""Port parity of the functions left from earlier slices, against the JAX
package on the CPU: the landmark birth filter (``SlamConfig.lm_refine_cap``,
``system._refine_landmarks``), frame-to-frame tracking
(``tracking.track_sequence``), ``extract_learned_features`` with
``use_confidence`` and ``normalized``, ``selector.refine_keypoints``,
``uncertainty.confidence_mask``, the Lie and camera helpers, and
``utils/profiling.py``'s recorder (against ``StageTimer``), ``stage_cost`` and
``device_trace``.

Tolerances, and why: masks, counts and keyframes are held exactly. The
filter's positions are a handful of f32 multiply-adds, within 1e-6.
Tracking poses come from the same RANSAC draws (``core.prng``) through
solvers whose f32 arithmetic orders differ, so within 1e-3 m and 1e-3 rad,
as tests/test_torch_slam.py holds ``run_slam``. The tiny f32 learned
frontend agrees within 1e-5 (tests/test_torch_learned_slam.py); softmax
centroids and 3x3 products within 1e-6; homographies through a 3x3
inverse within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import camera as jcamera
from semantic_slam_master_tpu.core import lie as jlie
from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.models import frontend as jfrontend
from semantic_slam_master_tpu.models import selector as jselector
from semantic_slam_master_tpu.models import uncertainty as juncertainty
from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu.utils import profiling as jprofiling
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.core import camera as tcamera
from semantic_slam_master_tpu_torch.core import lie as tlie
from semantic_slam_master_tpu_torch.core import prng
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.models import selector as tselector
from semantic_slam_master_tpu_torch.models import uncertainty as tuncertainty
from semantic_slam_master_tpu_torch.slam import system as tsystem
from semantic_slam_master_tpu_torch.slam import tracking as ttracking
from semantic_slam_master_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (six test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- landmark birth filter: tests/test_lm_filter.py's cases ---------------

def _lm_state(cfg, positions, counts):
    """The JAX test's map: the first len(positions) slots live."""
    state = jsystem.init_map(cfg)
    M = cfg.num_landmarks
    pos = np.zeros((M, 3), np.float32)
    obs = np.zeros((M,), np.float32)
    pos[: len(positions)] = positions
    obs[: len(counts)] = counts
    valid = np.zeros((M,), bool)
    valid[: len(positions)] = True
    return state._replace(positions=jnp.asarray(pos), lm_obs=jnp.asarray(obs), lm_valid=jnp.asarray(valid))


def _lm_case(name):
    """(cap, positions, counts, [(T_wc, pts_cam, lm_idx, mask), ...])."""
    rng = np.random.default_rng(0)
    eye = np.eye(4, dtype=np.float32)
    if name == "online_mean":
        samples = (np.array([1.0, 2.0, 3.0], np.float32) + rng.normal(0, 0.02, (12, 3))).astype(np.float32)
        return 16, samples[:1], [1.0], [(eye, s[None], [0], [True]) for s in samples[1:]]
    if name == "frozen_at_cap":
        return 4, np.ones((1, 3), np.float32), [4.0], [(eye, np.full((1, 3), 9.0, np.float32), [0], [True])]
    if name == "masked":
        pos = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]], np.float32)
        return 16, pos, [1.0, 1.0], [(eye, np.array([[9.0, 9.0, 9.0], [0.0, 0.0, 0.0]], np.float32), [0, 1],
                                      [False, False])]
    T_wc = eye.copy()
    T_wc[0, 3] = 2.0
    pt_world = np.array([[3.0, 0.0, 5.0]], np.float32)
    return 16, pt_world, [1.0], [(T_wc, pt_world - np.array([2.0, 0.0, 0.0], np.float32), [0], [True])]


@pytest.mark.parametrize("name", ["online_mean", "frozen_at_cap", "masked", "camera_frame"])
def test_refine_landmarks_matches_jax(name):
    cap, positions, counts, steps = _lm_case(name)
    jcfg = jsystem.SlamConfig(num_landmarks=8, window_size=2, lm_refine_cap=cap)
    tcfg = tsystem.SlamConfig(num_landmarks=8, window_size=2, lm_refine_cap=cap)
    jstate = _lm_state(jcfg, positions, counts)
    tstate = convert.map_state(jstate)
    for T_wc, pts, idx, mask in steps:
        jstate = jsystem._refine_landmarks(jstate, jnp.asarray(T_wc), jnp.asarray(pts),
                                           jnp.asarray(idx, jnp.int32), jnp.asarray(mask), jcfg)
        tstate = tsystem._refine_landmarks(tstate, _t(T_wc), _t(pts), torch.tensor(idx), torch.tensor(mask), tcfg)
    np.testing.assert_allclose(tstate.positions.numpy(), np.asarray(jstate.positions), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tstate.lm_obs.numpy(), np.asarray(jstate.lm_obs))
    if name == "online_mean":
        samples = np.concatenate([positions, np.concatenate([s[1] for s in steps])])
        np.testing.assert_allclose(tstate.positions[0].numpy(), samples.mean(0), atol=1e-5)
    if name in ("frozen_at_cap", "masked"):
        np.testing.assert_array_equal(tstate.positions[: len(positions)].numpy(), positions)


@pytest.fixture(scope="module")
def orb_features():
    """JAX's ORB features of 6 frames of the synthetic world at half scale."""
    seq = synthetic.make_sequence(num_frames=6, scale=0.5)
    frames = seq.frames()
    gray = jnp.stack([jimage.rgb_to_gray(jnp.asarray(f["rgb"])) for f in frames])
    depth = jnp.stack([jnp.asarray(f["depth"]) for f in frames])
    feats = jax.jit(lambda g, d: jtracking.extract_features(g, d, num_keypoints=300))(gray, depth)
    return seq, jax.device_get(feats)


def _pose_gap(P, Q):
    dt = np.abs(P[:, :3, 3] - Q[:, :3, 3]).max()
    rel = np.einsum("fji,fjk->fik", P[:, :3, :3].astype(np.float64), Q[:, :3, :3])
    return dt, np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)).max()


def test_run_slam_with_the_filter_on_matches_jax(orb_features):
    """``lm_refine_cap > 0`` through ``run_slam``: the filter runs on every
    tracked frame at JAX's place."""
    seq, feats = orb_features
    jcfg = jsystem.SlamConfig(num_landmarks=1024, window_size=3, ba_iters=2, lm_refine_cap=8)
    jout = jsystem.run_slam(jax.random.PRNGKey(1), jtracking.FrameFeatures(*map(jnp.asarray, feats)), seq.cam, jcfg)
    tcfg = tsystem.SlamConfig(num_landmarks=1024, window_size=3, ba_iters=2, lm_refine_cap=8)
    u = torch.from_numpy(prng.slam_uniforms(1, 6, tcfg.num_hypotheses))
    tout = tsystem.run_slam(u, convert.frame_features(feats), convert.camera(seq.cam), tcfg)
    np.testing.assert_array_equal(tout.is_keyframe.numpy(), np.asarray(jout.is_keyframe))
    np.testing.assert_array_equal(tout.num_inliers.numpy(), np.asarray(jout.num_inliers))
    dt, dr = _pose_gap(tout.poses_wc.numpy(), np.asarray(jout.poses_wc))
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)


# --- frame-to-frame tracking ----------------------------------------------

def test_track_sequence_matches_jax(orb_features):
    seq, feats = orb_features
    ref = jax.device_get(jtracking.track_sequence(jax.random.PRNGKey(0), jtracking.FrameFeatures(
        *map(jnp.asarray, feats)), seq.cam))
    got = ttracking.track_sequence(prng.PRNGKey(0), convert.frame_features(feats), convert.camera(seq.cam))
    assert got.poses_wc.shape == (6, 4, 4)
    np.testing.assert_array_equal(got.num_matches.numpy(), np.asarray(ref.num_matches))
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(ref.num_inliers))
    assert got.num_inliers[1:].min() > 20
    dt, dr = _pose_gap(got.poses_wc.numpy(), np.asarray(ref.poses_wc))
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse), rtol=0, atol=1e-3)


def test_track_sequence_falls_back_to_constant_position():
    """tests/test_tracking.py's featureless frames: identity poses, finite."""
    cam = synthetic.make_sequence(1, scale=0.25).cam
    feats = ttracking.extract_features(torch.zeros((3, 120, 160)), torch.ones((3, 120, 160)), num_keypoints=100)
    got = ttracking.track_sequence(prng.PRNGKey(0), feats, convert.camera(cam))
    np.testing.assert_array_equal(got.poses_wc.numpy(), np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)))
    assert (got.num_inliers == 0).all()


# --- learned features: the two flags --------------------------------------

@pytest.mark.parametrize("use_confidence,normalized", [(False, False), (True, True)])
def test_extract_learned_features_flags_match_jax(use_confidence, normalized):
    seq = synthetic.make_sequence(num_frames=2, scale=0.5)
    rgb = np.stack([seq.frame(i)["rgb"] for i in range(2)]).astype(np.float32)[:, :224, :304]
    depth = np.stack([seq.frame(i)["depth"] for i in range(2)]).astype(np.float32)[:, :224, :304]
    if normalized:
        rgb = (rgb - np.array([0.485, 0.456, 0.406], np.float32)) / np.array([0.229, 0.224, 0.225], np.float32)
    jm = jfrontend.tiny_frontend(subpatch_refine=True, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 224, 304, 3))))
    ref = jax.device_get(jax.jit(lambda r, d: jtracking.extract_learned_features(
        jm, variables, r, d, use_confidence=use_confidence, normalized=normalized))(jnp.asarray(rgb), jnp.asarray(depth)))
    tm = tfrontend.tiny_frontend(subpatch_refine=True, dtype=torch.float32)
    tm.load_state_dict(convert.frontend_state_dict(variables))
    got = ttracking.extract_learned_features(tm.eval(), _t(rgb), _t(depth), use_confidence=use_confidence,
                                             normalized=normalized)
    assert np.abs(got.xy.numpy() - ref.xy).max() <= 1e-3
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_allclose(got.desc.numpy(), ref.desc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sem_weight.numpy(), ref.sem_weight, rtol=0, atol=1e-5)
    assert (got.sem_weight.numpy() == 1.0).all() == (not use_confidence)


# --- selector, uncertainty ------------------------------------------------

@pytest.mark.parametrize("channel", [False, True])
def test_refine_keypoints_matches_jax(channel):
    rng = np.random.default_rng(1)
    sal = rng.uniform(0, 1, (2, 7, 9)).astype(np.float32)
    xy = np.stack([rng.integers(0, 9, (2, 12)), rng.integers(0, 7, (2, 12))], -1).astype(np.float32)
    xy[0, :3] = [[0, 0], [8, 6], [8, 0]]  # corners: clamped neighbours
    if channel:
        sal = sal[..., None]
    for temperature in (0.05, 0.5):
        ref = np.asarray(jselector.refine_keypoints(jnp.asarray(sal), jnp.asarray(xy), temperature))
        got = tselector.refine_keypoints(_t(sal), _t(xy), temperature).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        assert (got >= 0).all() and (got[..., 0] <= 8).all() and (got[..., 1] <= 6).all()


def test_confidence_mask_matches_jax():
    rng = np.random.default_rng(2)
    conf = rng.uniform(0, 1, (4, 10, 1)).astype(np.float32)
    conf[1] = 0.2  # all below the threshold, all tied: the first is kept
    conf[2, :, 0] = np.linspace(0.0, 0.45, 10)  # all below: the best is kept
    conf[3, 4] = 0.5  # exactly on the threshold
    for threshold in (0.5, 0.9):
        ref = np.asarray(juncertainty.confidence_mask(jnp.asarray(conf), threshold))
        got = tuncertainty.confidence_mask(_t(conf), threshold).numpy()
        np.testing.assert_array_equal(got, ref)
    assert got.sum(-1).min() >= 1


# --- lie and camera -------------------------------------------------------

def _poses(n, seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def test_relative_pose_and_rotation_angle_match_jax():
    T1, T2 = _poses(5, 3), _poses(5, 4)
    ref = np.asarray(jlie.relative_pose(jnp.asarray(T1), jnp.asarray(T2)))
    got = tlie.relative_pose(_t(T1), _t(T2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    R = np.concatenate([T1[:, :3, :3], np.eye(3, dtype=np.float32)[None], -np.eye(3, dtype=np.float32)[None]])
    R[-1, 2, 2] = 1.0  # a rotation by pi
    np.testing.assert_allclose(tlie.rotation_angle(_t(R)).numpy(), np.asarray(jlie.rotation_angle(jnp.asarray(R))),
                               rtol=0, atol=1e-6)


def test_camera_matrices_and_homographies_match_jax():
    jcam = jcamera.TUM_FR2.scaled(0.5, 0.5)
    tcam = convert.camera(jcam)
    np.testing.assert_array_equal(tcam.K.numpy(), np.asarray(jcam.K))
    np.testing.assert_array_equal(tcam.K_inv.numpy(), np.asarray(jcam.K_inv))
    assert tcam.K.dtype == torch.float32
    R = _poses(1, 5)[0, :3, :3]
    Hj = np.asarray(jcamera.rotation_homography(jcam.K, jnp.asarray(R)))
    Ht = tcamera.rotation_homography(tcam.K, _t(R)).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-5, atol=1e-5)
    pts = np.random.default_rng(6).uniform(0, 320, (2, 30, 2)).astype(np.float32)
    H = np.stack([Hj, np.diag([1.0, 1.0, 0.0]).astype(np.float32)])  # a degenerate one: w = 0
    H[1, 2, 2] = 0.0
    for h in H:
        ref = np.asarray(jcamera.apply_homography(jnp.asarray(h), jnp.asarray(pts)))
        got = tcamera.apply_homography(_t(h), _t(pts)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# --- profiling ------------------------------------------------------------

def test_stage_timer_matches_jax_report():
    """The recorder's named spans total what the JAX package's
    ``StageTimer`` reports: the same stages, the same counts, a raising
    stage still timed."""
    timer = jprofiling.StageTimer()
    for name in ("a", "b", "a"):
        with timer.stage(name):
            pass
    with pytest.raises(KeyError), timer.stage("c"):
        raise KeyError("the stage is still timed")
    ref = timer.report()
    with profiling.span("stages"):
        for name in ("a", "b", "a"):
            with profiling.span(name):
                pass
        with pytest.raises(KeyError), profiling.span("c"):
            raise KeyError("the stage is still timed")
    got = next(c for c in reversed(profiling.calls()) if c["name"] == "stages")["spans"]
    assert set(got) - {"stages"} == set(ref) == {"a", "b", "c"}
    for k in ref:
        assert got[k]["count"] == ref[k]["count"]
        assert got[k]["host_ns"] >= 0 and ref[k]["total_s"] >= 0
    assert got["a"]["count"] == 2


def test_stage_cost_counts_matmul_flops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    got = profiling.stage_cost(lambda x, y: torch.relu(x @ y), (a, b))
    ref = jprofiling.stage_cost(lambda x, y: x @ y, (jnp.ones((8, 16)), jnp.ones((16, 4))))
    assert set(got) == set(ref) == {"flops", "bytes"}
    assert got == {"flops": 2.0 * 8 * 16 * 4, "bytes": 0.0}


def test_device_trace(tmp_path):
    with profiling.device_trace(None):
        torch.ones(3).sum()
    assert not any(tmp_path.iterdir())
    with profiling.device_trace(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json") and files[0].stat().st_size > 0
