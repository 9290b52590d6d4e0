"""Port parity: loop closing (``slam/loop_closing.py``, ``slam/online.py``,
``system.refine_active_map`` and ``system.run_slam_steps``) of
semantic_slam_master_tpu_torch against the JAX package on the CPU, fed
the JAX package's features of a self-retracing trajectory (16 frames out
and back at scale 0.5, tests/test_online_slam.py's fixture) and JAX's
RANSAC draws for the same seeds (``core/prng.py``).

Tolerances:
- ``verify_candidates``: the same accept decisions and inlier counts,
  loop transforms Z within 1e-4;
- ``refine_active_map`` on a converted ``MapState``: landmark positions
  and window poses within 1e-4 (f32 LM window BA, as
  tests/test_torch_ba.py);
- the chunked run with loop closure off equals the port's ``run_slam``
  bit for bit;
- ``run_slam_online`` and ``close_sequence_loops``: the same accepted
  loops (frame pairs) and keyframes, poses within 1e-3 m and 1e-3 rad
  (f32 RANSAC, BA and pose-graph solves);
- the CLI's ``--loop-closure offline|online`` on the CPU: with no loop
  accepted both write the trajectory of ``--loop-closure off`` exactly,
  and report ``loops_closed``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.slam import loop_closing as jlc
from semantic_slam_master_tpu.slam import online as jonline
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.core import prng
from semantic_slam_master_tpu_torch.slam import loop_closing as tlc
from semantic_slam_master_tpu_torch.slam import online as tonline
from semantic_slam_master_tpu_torch.slam import system as tsystem

# A keyframe on every tracked frame the gap allows, so the BoW database
# has nodes along the whole retraced path (tests/test_online_slam.py).
CFG = dict(num_landmarks=1024, window_size=4, ba_iters=2, keyframe_min_inlier_ratio=1.1)
LOOP = dict(min_frame_gap=6, min_score=0.2, min_inliers=15)
SEED = 0


@pytest.fixture(scope="module")
def fixture():
    ts, poses = synthetic.orbit_trajectory(8)
    seq = synthetic.SyntheticSequence(
        cam=synthetic.TUM_FR2.scaled(0.5, 0.5),
        timestamps=np.arange(16) / 30.0,
        poses_wc=np.concatenate([poses, poses[::-1]], axis=0),
    )
    frames = seq.frames()
    gray = jnp.stack([jimage.rgb_to_gray(jnp.asarray(f["rgb"])) for f in frames])
    depth = jnp.stack([jnp.asarray(f["depth"]) for f in frames])
    feats = jax.jit(lambda g, d: jtracking.extract_features(g, d, num_keypoints=300))(gray, depth)
    return seq, jax.device_get(feats)


def _poses_close(P, Q, tol=1e-3):
    """Translations within ``tol`` m and rotations within ``tol`` rad, the
    angle as 2 asin(|R_P - R_Q|_F / sqrt(8)) (0 for equal matrices)."""
    P, Q = np.asarray(P, np.float64), np.asarray(Q, np.float64)
    np.testing.assert_allclose(P[:, :3, 3], Q[:, :3, 3], atol=tol)  # metres
    fro = np.linalg.norm(P[:, :3, :3] - Q[:, :3, :3], axis=(1, 2))
    angles = 2 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0))
    assert angles.max() < tol, angles  # radians


def _uniforms(F, cfg):
    return torch.from_numpy(prng.slam_uniforms(SEED, F, cfg.num_hypotheses))


def test_verify_candidates_matches_jax(fixture):
    seq, jfeats = fixture
    feats = convert.frame_features(jfeats)
    cam = convert.camera(seq.cam)
    # Pairs that retrace each other (frame f and 15 - f), a far pair, and
    # one that the odometry gate must judge against ground-truth poses.
    cands = [(15, 0, 0.9), (13, 2, 0.8), (11, 4, 0.7), (9, 1, 0.6), (12, 3, 0.5)]
    poses = np.asarray(seq.poses_wc, np.float64)
    for kw in (dict(), dict(poses_wc=poses)):
        j_edges, j_acc = jlc.verify_candidates(cands, jfeats, seq.cam, 15, 4, seed=5, **kw)
        t_edges, t_acc = tlc.verify_candidates(cands, feats, cam, 15, 4, seed=5, **kw)
        assert t_acc == j_acc
        assert len(t_acc) >= 2
        for (ti, tj, tZ, tw), (ji, jj, jZ, jw) in zip(t_edges, j_edges):
            assert (ti, tj, tw) == (ji, jj, jw)
            np.testing.assert_allclose(tZ, np.asarray(jZ), atol=1e-4)


def test_loop_edge_pose_inliers_match_jax(fixture):
    seq, jfeats = fixture
    feats = convert.frame_features(jfeats)
    key = jax.random.PRNGKey(9)
    fi, fj = 14, 1
    jZ, j_inl, j_cnt = jlc._loop_edge_pose(key, jax.tree.map(lambda x: x[fi], jfeats),
                                           jax.tree.map(lambda x: x[fj], jfeats), seq.cam, 15)
    u = torch.from_numpy(prng.uniform(prng.PRNGKey(9), (tlc.LOOP_HYPOTHESES, 3)))
    tZ, t_inl, t_cnt = tlc._loop_edge_pose(u, tsystem.frame(feats, fi), tsystem.frame(feats, fj),
                                           convert.camera(seq.cam))
    assert (t_inl, t_cnt) == (j_inl, j_cnt)
    assert t_inl >= 15
    np.testing.assert_allclose(tZ.numpy(), np.asarray(jZ), atol=1e-4)


def test_refine_active_map_matches_jax(fixture):
    seq, jfeats = fixture
    jcfg = jsystem.SlamConfig(**CFG)
    first = jax.tree.map(lambda x: x[0], jfeats)
    state = jsystem.bootstrap_map(first, seq.cam, jcfg)
    rest = jax.tree.map(lambda x: jnp.asarray(x[1:7]), jfeats)
    keys = jax.random.split(jax.random.PRNGKey(SEED), 7)[1:]
    (state, _, _), _ = jsystem.run_slam_steps(keys, rest, seq.cam, jcfg, state, jnp.eye(4),
                                              jnp.asarray(0, jnp.int32))
    # a rigid correction first, as a closing pass applies one
    delta = np.asarray(jax.device_get(jnp.asarray(
        [[0.9998, -0.02, 0, 0.03], [0.02, 0.9998, 0, -0.01], [0, 0, 1, 0.02], [0, 0, 0, 1]])))
    jstate, _ = jonline._apply_correction(state, jnp.eye(4), jnp.asarray(delta, jnp.float32))
    tstate, _ = tonline._apply_correction(convert.map_state(state), torch.eye(4), delta)
    np.testing.assert_allclose(tstate.positions.numpy(), np.asarray(jstate.positions), atol=1e-5)
    np.testing.assert_allclose(tstate.kf_poses.numpy(), np.asarray(jstate.kf_poses), atol=1e-5)

    # then one window pose off by 2 cm, which the refinement must absorb
    kf = np.array(jstate.kf_poses)
    kf[1, :3, 3] += 0.02
    jstate = jstate._replace(kf_poses=jnp.asarray(kf))

    tcfg = tsystem.SlamConfig(**CFG)
    j = jsystem.refine_active_map(jstate, seq.cam, jcfg)
    t = tsystem.refine_active_map(convert.map_state(jstate), convert.camera(seq.cam), tcfg)
    assert int(np.asarray(jstate.kf_used).sum()) >= 3
    np.testing.assert_allclose(t.positions.numpy(), np.asarray(j.positions), atol=1e-4)
    np.testing.assert_allclose(t.kf_poses.numpy(), np.asarray(j.kf_poses), atol=1e-4)
    moved = max(np.abs(np.asarray(j.positions) - np.asarray(jstate.positions)).max(),
                np.abs(np.asarray(j.kf_poses) - kf).max())
    assert moved > 1e-3  # the refinement did something


@pytest.fixture(scope="module")
def port_run(fixture):
    seq, jfeats = fixture
    feats = convert.frame_features(jfeats)
    cam, cfg = convert.camera(seq.cam), tsystem.SlamConfig(**CFG)
    u = _uniforms(16, cfg)
    return feats, cam, cfg, u, tsystem.run_slam(u, feats, cam, cfg)


@pytest.mark.parametrize("chunk_size", [4, 5, 32])
def test_chunked_run_equals_run_slam(port_run, chunk_size):
    feats, cam, cfg, u, ref = port_run
    out, loops = tonline.run_slam_online(u, feats, cam, cfg, chunk_size=chunk_size,
                                         enable_loop_closure=False)
    assert loops == []
    for a, b in zip(out, ref):
        assert torch.equal(a, b.to(a.dtype)), (a, b)


def test_run_slam_online_matches_jax(fixture):
    seq, jfeats = fixture
    jcfg, tcfg = jsystem.SlamConfig(**CFG), tsystem.SlamConfig(**CFG)
    j_out, j_loops = jonline.run_slam_online(jax.random.PRNGKey(SEED), jfeats, seq.cam, jcfg,
                                             chunk_size=4, **LOOP)
    timings = []
    t_out, t_loops = tonline.run_slam_online(_uniforms(16, tcfg), convert.frame_features(jfeats),
                                             convert.camera(seq.cam), tcfg, chunk_size=4,
                                             timings=timings, **LOOP)
    assert len(j_loops) >= 1
    assert [(a, b) for a, b, _ in t_loops] == [(a, b) for a, b, _ in j_loops]
    np.testing.assert_allclose([s for *_, s in t_loops], [s for *_, s in j_loops], atol=1e-6)
    np.testing.assert_array_equal(t_out.is_keyframe.numpy(), np.asarray(j_out.is_keyframe))
    np.testing.assert_array_equal(t_out.num_inliers.numpy(), np.asarray(j_out.num_inliers))
    _poses_close(t_out.poses_wc.numpy(), j_out.poses_wc)
    assert [t["start"] for t in timings] == [1, 5, 9, 13]
    assert [t["frames"] for t in timings] == [4, 4, 4, 3]


def test_close_sequence_loops_matches_jax(fixture, port_run):
    seq, jfeats = fixture
    feats, cam, _, _, t_run = port_run
    j_run = jsystem.run_slam(jax.random.PRNGKey(SEED), jfeats, seq.cam, jsystem.SlamConfig(**CFG))
    np.testing.assert_array_equal(t_run.is_keyframe.numpy(), np.asarray(j_run.is_keyframe))
    # Both close loops over the same (JAX's) odometry.
    poses = np.asarray(j_run.poses_wc, np.float64)
    is_kf = np.asarray(j_run.is_keyframe)
    j_poses, j_loops = jlc.close_sequence_loops(poses, jfeats, is_kf, seq.cam, **LOOP)
    t_poses, t_loops = tlc.close_sequence_loops(poses, feats, is_kf, cam, **LOOP)
    assert len(j_loops) >= 1
    assert [(a, b) for a, b, _ in t_loops] == [(a, b) for a, b, _ in j_loops]
    _poses_close(t_poses, j_poses)
    assert not np.allclose(t_poses, poses)  # the correction moved the trajectory
    # Loops already closed are skipped.
    _, again = tlc.close_sequence_loops(poses, feats, is_kf, cam, exclude=t_loops, **LOOP)
    assert not {(a, b) for a, b, _ in again} & {(a, b) for a, b, _ in t_loops}


def test_close_sequence_loops_needs_three_keyframes(fixture):
    seq, jfeats = fixture
    feats = convert.frame_features(jfeats)
    poses = np.tile(np.eye(4), (16, 1, 1))
    is_kf = np.zeros(16, bool)
    is_kf[[0, 9]] = True
    out, loops = tlc.close_sequence_loops(poses, feats, is_kf, convert.camera(seq.cam))
    assert loops == [] and np.array_equal(out, poses)


def _cli(out, *flags):
    argv = ["--synthetic", "--synthetic-frames", "10", "--synthetic-scale", "0.5", "--num-keypoints",
            "300", "--num-landmarks", "1024", "--window-size", "4", "--ba-iters", "2",
            "--device", "cpu", "--output-dir", str(out), *flags]
    assert run_slam_cli.main(argv) == 0
    run = json.loads(next(out.glob("*_run.json")).read_text())
    return run, next(out.glob("*_trajectory.txt")).read_text()


def test_cli_loop_closure_modes(tmp_path):
    off_run, off_traj = _cli(tmp_path / "off")
    assert off_run["loops_closed"] == 0 and off_run["loop_closure"] == "off"
    for mode in ("offline", "online"):
        run, traj = _cli(tmp_path / mode, "--loop-closure", mode, "--chunk-size", "4")
        assert run["loop_closure"] == mode
        assert run["loops_closed"] == len(run["loops"]) == 0  # 10 frames: no revisit
        assert traj == off_traj
        assert run["finite_poses"]


def test_cli_bare_loop_closure_flag_means_offline(monkeypatch, tmp_path):
    seen = {}

    def fake_run(seq, out_path, args, device):
        seen.update(vars(args))
        return {}

    monkeypatch.setattr(run_slam_cli, "run_sequence", fake_run)
    run_slam_cli.main(["--synthetic", "--synthetic-frames", "2", "--synthetic-scale", "0.25",
                       "--device", "cpu", "--output-dir", str(tmp_path), "--loop-closure"])
    assert seen["loop_closure"] == "offline" and seen["chunk_size"] == 32
