"""Port parity: image ops, sampling and the image pyramid of
semantic_slam_master_tpu_torch against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.ops import sampling as jsampling
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch.ops import image as timage
from semantic_slam_master_tpu_torch.ops import sampling as tsampling
from semantic_slam_master_tpu_torch.slam import tracking as ttracking


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("sigma,radius", [(1.0, 2), (2.0, 3)])
def test_gaussian_blur_matches(sigma, radius):
    img = _frames((2, 61, 83))
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma, radius))
    got = timage.gaussian_blur(_t(img), sigma, radius).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_max_pool_same_matches_exactly(radius):
    img = _frames((2, 37, 50), seed=radius)
    ref = np.asarray(jimage.max_pool_same(jnp.asarray(img), radius))
    np.testing.assert_array_equal(timage.max_pool_same(_t(img), radius).numpy(), ref)


def test_nearest_sample_matches_exactly():
    rng = np.random.default_rng(5)
    grid = _frames((2, 30, 40))
    # Half-pixel ties (round half to even) and out-of-frame clamps.
    xy = rng.uniform(-5, 45, size=(2, 64, 2)).astype(np.float32)
    xy[:, :8] = np.round(xy[:, :8]) + 0.5
    ref = np.asarray(jsampling.nearest_sample(jnp.asarray(grid), jnp.asarray(xy)))
    np.testing.assert_array_equal(tsampling.nearest_sample(_t(grid), _t(xy)).numpy(), ref)
    grid_c = _frames((2, 30, 40, 3))
    ref_c = np.asarray(jsampling.nearest_sample(jnp.asarray(grid_c), jnp.asarray(xy)))
    np.testing.assert_array_equal(tsampling.nearest_sample(_t(grid_c), _t(xy)).numpy(), ref_c)


@pytest.mark.parametrize("n_in,n_out", [(480, 400), (640, 544), (400, 336), (544, 448), (320, 256), (120, 96)])
def test_resize_weights_match_jax(n_in, n_out):
    ref = np.asarray(
        compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True)
    )
    # Equal up to the f32 summation order of the normalising column sums
    # (numpy pairwise vs XLA): two ulps of 1.0.
    np.testing.assert_allclose(timage._resize_weights(n_in, n_out), ref, atol=2.5e-7, rtol=0)


@pytest.mark.parametrize("H,W", [(240, 320), (480, 640)])
def test_pyramid_matches(H, W):
    gray = _frames((1, H, W), seed=H)
    ref = jax.jit(lambda g: jtracking.build_pyramid(g, 4))(jnp.asarray(gray))
    got = ttracking.build_pyramid(_t(gray), 4)
    assert [tuple(p.shape) for p in got] == [tuple(p.shape) for p in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)
