"""Port parity: core math (fixed-shape top-k, Lie groups, camera) of
semantic_slam_master_tpu_torch against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import camera as jcam
from semantic_slam_master_tpu.core import fixed as jfixed
from semantic_slam_master_tpu.core import lie as jlie
from semantic_slam_master_tpu_torch.core import camera as tcam
from semantic_slam_master_tpu_torch.core import fixed as tfixed
from semantic_slam_master_tpu_torch.core import lie as tlie
from semantic_slam_master_tpu_torch.core.device import resolve_device


def _t(x):
    return torch.from_numpy(np.array(x))


def test_precision_pins_tf32_off():
    import semantic_slam_master_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_masked_topk_tie_order_matches_lax(k):
    rng = np.random.default_rng(k)
    # Few distinct values -> many exact ties; some rows mostly masked.
    scores = rng.integers(0, 4, size=(6, 32)).astype(np.float32)
    mask = rng.random((6, 32)) < np.array([0.9, 0.5, 0.2, 0.05, 0.0, 1.0])[:, None]
    jv, ji, jvalid = jfixed.masked_topk(jnp.asarray(scores), jnp.asarray(mask), k)
    tv, ti, tvalid = tfixed.masked_topk(_t(scores), _t(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_inv3x3_matches():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    V = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        tfixed.inv3x3(_t(V)).numpy(), np.asarray(jfixed.inv3x3(jnp.asarray(V))), rtol=1e-5, atol=1e-6
    )


def _phis(rng, n):
    # Generic angles, tiny angles (Taylor branches) and angles near pi.
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.1, 3.0, n - 6), [1e-5, 3e-4, 0.0, 3.1415, 3.14, 2.0]])
    return (axis * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize(
    "name", ["so3_exp", "so3_log", "se3_exp", "se3_log", "quat_to_matrix", "matrix_to_quat", "pose_inverse"]
)
def test_lie_matches(name):
    rng = np.random.default_rng(2)
    phi = _phis(rng, 24)
    rho = rng.normal(size=(24, 3)).astype(np.float32)
    xi = np.concatenate([rho, phi], axis=1)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    inputs = {
        "so3_exp": phi,
        "so3_log": T[:, :3, :3],
        "se3_exp": xi,
        "se3_log": T,
        "quat_to_matrix": rng.normal(size=(24, 4)).astype(np.float32),
        "matrix_to_quat": T[:, :3, :3],
        "pose_inverse": T,
    }
    x = inputs[name]
    ref = np.asarray(getattr(jlie, name)(jnp.asarray(x)))
    got = getattr(tlie, name)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_transform_make_pose_matches():
    rng = np.random.default_rng(3)
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))))
    pts = rng.normal(size=(4, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.transform_points(_t(T), _t(pts)).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T), jnp.asarray(pts))),
        atol=1e-6,
    )
    R, t = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(tlie.make_pose(_t(R), _t(t)).numpy(), np.asarray(jlie.make_pose(R, t)))


def test_camera_matches():
    rng = np.random.default_rng(4)
    jc = jcam.TUM_FR2.scaled(0.5, 0.5)
    tc = tcam.TUM_FR2.scaled(0.5, 0.5)
    assert tuple(tc) == tuple(jc)
    pts = np.concatenate(
        [rng.normal(size=(64, 2)), rng.uniform(0.5, 4.0, size=(64, 1))], axis=1
    ).astype(np.float32)
    pts[0, 2] = 0.0  # the z clamp
    np.testing.assert_allclose(
        tcam.project(_t(pts), tc).numpy(), np.asarray(jcam.project(jnp.asarray(pts), jc)), atol=1e-6, rtol=1e-6
    )
    px = rng.uniform(-10, 330, size=(64, 2)).astype(np.float32)
    depth = rng.uniform(0.1, 5, size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(_t(px), _t(depth), tc).numpy(),
        np.asarray(jcam.backproject(jnp.asarray(px), jnp.asarray(depth), jc)),
        atol=1e-6,
    )
    for margin in (0.0, 16.0):
        np.testing.assert_array_equal(
            tcam.in_bounds(_t(px), tc, margin).numpy(), np.asarray(jcam.in_bounds(jnp.asarray(px), jc, margin))
        )
