"""Port parity: PnP (Horn-Kabsch, Gauss-Newton refinement, inlier count,
RANSAC with injected uniforms) of semantic_slam_master_tpu_torch against
the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import camera as jcam
from semantic_slam_master_tpu.core import lie as jlie
from semantic_slam_master_tpu.slam import pnp as jpnp
from semantic_slam_master_tpu_torch.core import camera as tcam
from semantic_slam_master_tpu_torch.slam import pnp as tpnp

JCAM = jcam.TUM_FR2.scaled(0.5, 0.5)
TCAM = tcam.TUM_FR2.scaled(0.5, 0.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed, n=200, outliers=0.3):
    """World points, their camera-frame backprojections and pixels under
    a known pose, with pixel/depth noise and gross outliers."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, [0.1, 0.1, 0.1, 0.05, 0.05, 0.05]).astype(np.float32))))
    pc = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(1.5, 4.0, n)], -1
    ).astype(np.float32)
    Tinv = np.linalg.inv(T.astype(np.float64))
    pw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    obs = np.asarray(jcam.project(jnp.asarray(pc), JCAM)) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    bad = rng.random(n) < outliers
    obs[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    pc_meas = (pc * (1 + rng.normal(0, 0.005, (n, 1)))).astype(np.float32)
    valid = rng.random(n) < 0.95
    weights = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return T, pw, pc_meas, obs.astype(np.float32), valid, weights


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_matches(seed):
    _, pw, pc, _, _, w = _problem(seed)
    for sl, ww in [(slice(0, 3), None), (slice(0, 50), w[:50]), (slice(None), w)]:
        ref = np.asarray(jpnp.kabsch(jnp.asarray(pw[sl]), jnp.asarray(pc[sl]),
                                     None if ww is None else jnp.asarray(ww)))
        got = tpnp.kabsch(_t(pw[sl]), _t(pc[sl]), None if ww is None else _t(ww)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_kabsch_batched_equals_single():
    _, pw, pc, _, _, _ = _problem(3)
    idx = np.random.default_rng(0).integers(0, 200, size=(16, 3))
    batched = tpnp.kabsch(_t(pw[idx]), _t(pc[idx])).numpy()
    for h in range(16):
        np.testing.assert_array_equal(batched[h], tpnp.kabsch(_t(pw[idx[h]]), _t(pc[idx[h]])).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_and_count_match(seed):
    T, pw, _, obs, valid, w = _problem(seed, outliers=0.0)
    T0 = T @ np.asarray(jlie.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.01], jnp.float32)))
    ref = np.asarray(jpnp.refine_pose(jnp.asarray(T0), jnp.asarray(pw), jnp.asarray(obs), JCAM, jnp.asarray(w)))
    got = tpnp.refine_pose(_t(T0), _t(pw), _t(obs), TCAM, _t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    jn, jm = jpnp.count_inliers(jnp.asarray(ref), jnp.asarray(pw), jnp.asarray(obs), JCAM, jnp.asarray(valid))
    tn, tm = tpnp.count_inliers(_t(ref), _t(pw), _t(obs), TCAM, _t(valid))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_indices_match_jax_choice(seed):
    rng = np.random.default_rng(seed)
    w = (rng.random(300) < 0.7) * rng.uniform(0.1, 1.0, 300)
    probs = (w + 1e-6).astype(np.float32)
    probs = probs / probs.sum()
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.choice(key, 300, shape=(64, 3), replace=True, p=jnp.asarray(probs)))
    u = np.asarray(jax.random.uniform(key, (64, 3)))
    got = tpnp.sample_indices(_t(probs), _t(u)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_matches_with_injected_uniforms(seed):
    T, pw, pc, obs, valid, w = _problem(seed)
    key = jax.random.PRNGKey(10 + seed)
    ref = jpnp.ransac_pose(key, jnp.asarray(pw), jnp.asarray(pc), jnp.asarray(obs), JCAM,
                           jnp.asarray(valid), weights=jnp.asarray(w), num_hypotheses=64)
    u = np.asarray(jax.random.uniform(key, (64, 3)))
    got = tpnp.ransac_pose(_t(u), _t(pw), _t(pc), _t(obs), TCAM, _t(valid), weights=_t(w))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), atol=1e-4)
    # And it found the true pose.
    np.testing.assert_allclose(got.pose.numpy(), T, atol=0.02)
