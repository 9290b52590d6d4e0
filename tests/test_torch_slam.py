"""Port parity: the SLAM backend (``run_slam``) of semantic_slam_master_tpu_torch
fed the JAX package's own features, converted by ``convert.py``, with
the RANSAC uniforms JAX draws from the same keys, against the JAX
``run_slam`` on the CPU; plus ``convert.py`` round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.ops import orb as torb
from semantic_slam_master_tpu_torch.slam import system as tsystem

FRAMES = 8
SEED = 3
JCFG = jsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
TCFG = tsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)


@pytest.fixture(scope="module")
def jax_run():
    seq = synthetic.make_sequence(num_frames=FRAMES, scale=0.5)
    fr = [seq.frame(i) for i in range(FRAMES)]
    rgb = np.stack([f["rgb"] for f in fr]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in fr]).astype(np.float32)
    feats = jax.jit(lambda g, d: jtracking.extract_features(g, d, num_keypoints=400))(
        jnp.asarray(gray), jnp.asarray(depth)
    )
    key = jax.random.PRNGKey(SEED)
    out = jsystem.run_slam(key, feats, seq.cam, JCFG)
    return seq, jax.device_get(feats), jax.device_get(out)


def _uniforms(key, F, H):
    keys = jax.random.split(key, F)
    u = [np.zeros((H, 3), np.float32)] + [np.asarray(jax.random.uniform(k, (H, 3))) for k in keys[1:]]
    return torch.from_numpy(np.stack(u))


def test_run_slam_matches_jax_on_jax_features(jax_run):
    seq, jfeats, jout = jax_run
    feats = convert.frame_features(jfeats)
    u = _uniforms(jax.random.PRNGKey(SEED), FRAMES, TCFG.num_hypotheses)
    out = tsystem.run_slam(u, feats, convert.camera(seq.cam), TCFG)
    np.testing.assert_array_equal(out.is_keyframe.numpy(), np.asarray(jout.is_keyframe))
    assert out.is_keyframe.sum() >= 2
    np.testing.assert_array_equal(out.num_matches.numpy(), np.asarray(jout.num_matches))
    np.testing.assert_array_equal(out.num_inliers.numpy(), np.asarray(jout.num_inliers))
    P, Q = out.poses_wc.numpy(), np.asarray(jout.poses_wc)
    np.testing.assert_allclose(P[:, :3, 3], Q[:, :3, 3], atol=1e-3)  # metres
    rel = np.einsum("fji,fjk->fik", P[:, :3, :3].astype(np.float64), Q[:, :3, :3])
    angles = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angles.max() < 1e-3, angles  # radians


def test_run_slam_accepts_a_generator(jax_run):
    seq, jfeats, _ = jax_run
    feats = convert.frame_features(jfeats)
    cam = convert.camera(seq.cam)
    a = tsystem.run_slam(torch.Generator().manual_seed(0), feats, cam, TCFG)
    b = tsystem.run_slam(torch.Generator().manual_seed(0), feats, cam, TCFG)
    assert torch.equal(a.poses_wc, b.poses_wc)
    assert torch.isfinite(a.poses_wc).all()


def test_bootstrap_map_state_matches(jax_run):
    seq, jfeats, _ = jax_run
    first = jax.tree.map(lambda x: jnp.asarray(x[0]), jtracking.FrameFeatures(*jfeats))
    jstate = jax.device_get(jsystem.bootstrap_map(first, seq.cam, JCFG))
    tstate = tsystem.bootstrap_map(
        convert.frame_features(jax.tree.map(np.asarray, first)), convert.camera(seq.cam), TCFG
    )
    conv = convert.map_state(jstate)
    assert conv.write_ptr == tstate.write_ptr and conv.kf_ptr == tstate.kf_ptr
    for name in tsystem.MapState._fields:
        a, b = getattr(tstate, name), getattr(conv, name)
        if isinstance(a, int):
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)


def test_frame_features_round_trip(jax_run):
    _, jfeats, _ = jax_run
    back = convert.frame_features_to_numpy(convert.frame_features(jfeats))
    for name in jtracking.FrameFeatures._fields:
        ref = np.asarray(getattr(jfeats, name))
        assert back[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(back[name], ref)


def test_test_pattern_convert():
    p = convert.test_pattern(jorb._DEFAULT_PATTERN)
    np.testing.assert_array_equal(p, torb.DEFAULT_PATTERN)
    with pytest.raises(ValueError):
        convert.test_pattern(np.zeros((3, 4)))


def test_scatter_last_write_wins():
    dst = torch.zeros(4)
    out = tsystem._scatter(dst, torch.tensor([1, 4, 1, 2]), torch.tensor([5.0, 9.0, 7.0, 3.0]))
    ref = np.asarray(jnp.zeros(5).at[jnp.array([1, 4, 1, 2])].set(jnp.array([5.0, 9.0, 7.0, 3.0]))[:4])
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(dst, torch.zeros(4))
