"""Port parity: the square patch gather (``ops/sampling.py::
gather_patches``, the plain version of ``csrc/gather_patches.cu``) and its
padded twin against the JAX package on the CPU, and the bilinear sample
beside it.

A gather is a pure copy, so every comparison is exact. The padded mode
is held against the Pallas kernel itself in interpret mode, with the
three cases of tests/test_pallas_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.ops import sampling as jsampling
from semantic_slam_master_tpu.ops.pallas import patches as ppatches
from semantic_slam_master_tpu_torch.ops import sampling as tsampling
from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather


def _frame_and_centers(seed, B, H, W, N, lo, hi):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W)).astype(np.float32)
    centers = rng.uniform(lo, hi, size=(B, N, 2)).astype(np.float32)
    return img, centers


@pytest.mark.parametrize(
    "B,H,W,N,radius",
    [(2, 64, 96, 37, 10), (1, 48, 128, 8, 15), (3, 21, 21, 5, 10), (2, 120, 160, 50, 3)],
)
def test_gather_patches_matches_jax(B, H, W, N, radius):
    img, centers = _frame_and_centers(B * 1000 + N, B, H, W, N, -20.0, max(H, W) + 20.0)
    # Half-pixel ties (round half to even) and the exact clamp edges.
    centers[0, :4] = [[10.5, 11.5], [W - 1 - radius, H - 1 - radius], [radius, radius], [W / 2 - 0.5, 2.5]]
    ref = np.asarray(jsampling.gather_patches(jnp.asarray(img), jnp.asarray(centers), radius))
    got = tsampling.gather_patches(torch.from_numpy(img), torch.from_numpy(centers), radius)
    assert got.dtype == torch.float32 and got.shape == (B, N, 2 * radius + 1, 2 * radius + 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_patches_on_the_learned_path_shape():
    """The learned frontend's call: (8, 500) patch-centre keypoints of a
    30x40 patch grid, radius 10, on a 480x640 gray frame."""
    rng = np.random.default_rng(5)
    img = rng.random((8, 480, 640), dtype=np.float32)
    patch_xy = np.stack(
        [rng.integers(0, 40, (8, 500)), rng.integers(0, 30, (8, 500))], axis=-1
    ).astype(np.float32)
    centers = patch_xy * 16 + 8
    ref = np.asarray(jsampling.gather_patches(jnp.asarray(img), jnp.asarray(centers), 10))
    got = tsampling.gather_patches(torch.from_numpy(img), torch.from_numpy(centers), 10)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_padded_matches_pallas_kernel():
    B, H, W, N = 2, 64, 128, 16
    img, centers = _frame_and_centers(0, B, H, W, N, 17, 47)
    ref = np.asarray(ppatches.gather_patches_pallas(jnp.asarray(img), jnp.asarray(centers), 15, interpret=True))
    got = kgather.gather_patches_padded(torch.from_numpy(img), torch.from_numpy(centers), 15)
    assert got.shape == (B, N, 32, 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    prefix = tsampling.gather_patches(torch.from_numpy(img), torch.from_numpy(centers), 15)
    np.testing.assert_array_equal(got.numpy()[..., :31, :31], prefix.numpy())


def test_padded_border_clamp_matches_pallas_kernel():
    """Out-of-bounds centres clamp one pixel tighter on the bottom and
    right than gather_patches does."""
    B, H, W = 1, 48, 128
    img, _ = _frame_and_centers(1, B, H, W, 1, 0, 1)
    centers = np.array(
        [[[0.0, 0.0], [127.0, 47.0], [-5.0, 20.0], [60.0, 100.0],
          [20.0, 16.0], [110.0, 31.0], [64.0, 0.0], [0.0, 47.0]]], np.float32
    )
    ref = np.asarray(ppatches.gather_patches_pallas(jnp.asarray(img), jnp.asarray(centers), 15, interpret=True))
    got = kgather.gather_patches_padded(torch.from_numpy(img), torch.from_numpy(centers), 15)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_padded_ragged_group_matches_pallas_kernel():
    """N % 8 != 0: the Pallas kernel's group=1 path."""
    B, H, W, N = 1, 64, 128, 7
    img, centers = _frame_and_centers(2, B, H, W, N, 20, 40)
    ref = np.asarray(ppatches.gather_patches_pallas(jnp.asarray(img), jnp.asarray(centers), 15, interpret=True))
    got = kgather.gather_patches_padded(torch.from_numpy(img), torch.from_numpy(centers), 15)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    img = torch.zeros((1, 40, 40))
    xy = torch.full((1, 3, 2), 20.0)
    before = (kgather.gather_patches.launches, kgather.gather_patches_padded.launches)
    kgather.gather_patches(img, xy, 10)
    kgather.gather_patches_padded(img, xy, 15)
    assert (kgather.gather_patches.launches, kgather.gather_patches_padded.launches) == before
    with pytest.raises(TypeError):
        kgather.gather_patches(img.double(), xy, 10)
    with pytest.raises(ValueError):
        kgather.gather_patches(img, xy[0], 10)
    with pytest.raises(ValueError):
        kgather.gather_patches(torch.zeros((1, 20, 40)), xy, 10)
    with pytest.raises(ValueError):
        kgather.gather_patches_padded(img, xy, 16)


@pytest.mark.parametrize("H,W", [(30, 40), (7, 5), (2, 2)])
def test_bilinear_sample_matches_jax(H, W):
    rng = np.random.default_rng(H * W)
    grid = rng.normal(size=(2, H, W, 6)).astype(np.float32)
    xy = rng.uniform(-2.0, max(H, W) + 2.0, size=(2, 33, 2)).astype(np.float32)
    xy[0, :3] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.5, 0.25]]
    ref = np.asarray(jsampling.bilinear_sample(jnp.asarray(grid), jnp.asarray(xy)))
    got = tsampling.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(xy)).numpy()
    # Lerp weights are computed as in JAX; XLA may fuse a multiply-add.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
