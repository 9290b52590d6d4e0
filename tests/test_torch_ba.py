"""Port parity: Schur-complement Levenberg-Marquardt bundle adjustment of
semantic_slam_master_tpu_torch against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import camera as jcam
from semantic_slam_master_tpu.core import lie as jlie
from semantic_slam_master_tpu.slam import ba as jba
from semantic_slam_master_tpu_torch.core import camera as tcam
from semantic_slam_master_tpu_torch.slam import ba as tba

JCAM = jcam.TUM_FR2.scaled(0.5, 0.5)
TCAM = tcam.TUM_FR2.scaled(0.5, 0.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed, K=4, M=384):
    """A window of K cameras around M landmarks: noisy initial poses and
    points, pixel observations, measured depths, a validity mask with
    gaps and a few gross outliers."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0] = np.linspace(0, 0.3, K)
    xi[:, 4] = np.linspace(0, 0.1, K)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pts = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M), rng.uniform(2, 4, M)], -1).astype(np.float32)
    pc = np.einsum("kij,mj->kmi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    obs = np.asarray(jcam.project(jnp.asarray(pc), JCAM)) + rng.normal(0, 0.5, (K, M, 2))
    obs[rng.random((K, M)) < 0.03] += 30.0
    depth = pc[..., 2] * (1 + rng.normal(0, 0.003, (K, M)))
    depth[rng.random((K, M)) < 0.1] = 0.0
    valid = rng.random((K, M)) < 0.85
    conf = rng.uniform(0.5, 1.0, (K, M))
    noisy_poses = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.01, (K, 6)).astype(np.float32)))) @ poses
    noisy_poses[0] = poses[0]
    noisy_pts = pts + rng.normal(0, 0.02, pts.shape)
    f = lambda a: np.asarray(a, np.float32)
    return f(noisy_poses), f(noisy_pts), f(obs), valid, f(conf), f(depth)


@pytest.mark.parametrize("seed,iters", [(0, 2), (1, 3)])
def test_bundle_adjust_matches(seed, iters):
    poses, pts, obs, valid, conf, depth = _problem(seed)
    jprob = jba.BAProblem.create(jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(obs),
                                 jnp.asarray(valid), jnp.asarray(conf), jnp.asarray(depth))
    ref = jax.jit(lambda p: jba.bundle_adjust(p, JCAM, num_iters=iters))(jprob)
    tprob = tba.BAProblem(_t(poses), _t(pts), _t(obs), _t(valid), _t(conf), _t(depth))
    got = tba.bundle_adjust(tprob, TCAM, num_iters=iters)
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost), rtol=1e-4)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-4)
