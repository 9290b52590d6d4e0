"""Port parity: the aligned patch gather and the rBRIEF building blocks of
semantic_slam_master_tpu_torch against the JAX package on the CPU (the
Pallas gather in interpret mode). On the CPU the port's wrapper runs the kernel's
plain version; the CUDA kernel is held against it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu.ops.pallas import patches as jpatches
from semantic_slam_master_tpu_torch.ops import orb as torb
from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch


def _t(x):
    return torch.from_numpy(np.array(x))


def _edge_xy(H, W, rng, n_rand=8):
    """Keypoints on and beyond the right/bottom/left/top clamp edges, on
    half-pixel ties, plus interior ones."""
    edge = np.array(
        [[W - 18, H - 17], [W - 17.5, H - 16.5], [W - 1, H - 1], [W + 5, H + 2],
         [0, 0], [14.5, 15.5], [15.5, 14.5], [W / 2 + 0.5, H / 2 - 0.5]],
        np.float32,
    )
    interior = rng.uniform([16, 16], [W - 19, H - 18], size=(n_rand, 2)).astype(np.float32)
    return np.concatenate([edge, interior])[None]


@pytest.mark.parametrize("H,W", [(48, 256), (59, 300), (408, 544), (336, 448), (100, 300)])
def test_patch_gather_bit_exact_vs_pallas(H, W):
    """Plain gather == Pallas aligned gather on the pre-quantised bf16
    frame, at clamp edges, widths that are not multiples of 128 and
    H % 8 != 0."""
    rng = np.random.default_rng(H * W)
    img = rng.uniform(-0.1, 1.1, size=(1, H, W)).astype(np.float32)
    xy = _edge_xy(H, W, rng)
    imgq = jnp.round(jnp.clip(jnp.asarray(img), 0.0, 1.0) * 255.0).astype(jnp.bfloat16)
    ref = np.asarray(jpatches.gather_aligned_patches(imgq, jnp.asarray(xy), interpret=True))
    got = kpatch.gather_aligned_patches(_t(img), _t(xy))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


def test_patch_centers_and_quantize_match():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 700, size=(2, 64, 2)).astype(np.float32)
    xy[:, :16] = np.round(xy[:, :16]) + 0.5
    cx, cy = kpatch.patch_centers(_t(xy), 480, 640)
    jcx, jcy = jorb._patch_centers(jnp.asarray(xy), 480, 640)
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
    v = np.concatenate([rng.uniform(-0.2, 1.2, 1000), (np.arange(256) + 0.5) / 255]).astype(np.float32)
    np.testing.assert_array_equal(kpatch.quantize_u8(_t(v)).numpy(), np.asarray(jorb._quantize_u8(jnp.asarray(v))))


def test_patch_gather_rejects_bad_input():
    with pytest.raises(TypeError):
        kpatch.gather_aligned_patches(torch.zeros((1, 40, 40), dtype=torch.float64), torch.zeros((1, 2, 2)))
    with pytest.raises(ValueError):
        kpatch.gather_aligned_patches(torch.zeros((1, 20, 40)), torch.zeros((1, 2, 2)))


def test_pattern_and_bank_match():
    np.testing.assert_array_equal(torb.DEFAULT_PATTERN, jorb._DEFAULT_PATTERN)
    np.testing.assert_array_equal(torb._steered_pattern_bank(torb.DEFAULT_PATTERN), jorb._PATTERN_BANK)
    np.testing.assert_array_equal(
        torb._bin_select_matrices(torb._steered_pattern_bank(torb.DEFAULT_PATTERN)), jorb._BIN_SELECT
    )


def test_steered_bins_match():
    rng = np.random.default_rng(1)
    theta = np.concatenate(
        [rng.uniform(-7, 7, 4000), np.arange(-31, 32) * (np.pi / 15) + 1e-7, [0.0, -0.0, np.pi, -np.pi]]
    ).astype(np.float32)[None]
    np.testing.assert_array_equal(
        torb.steered_bins(_t(theta)).numpy(), np.asarray(jorb._steered_bins(jnp.asarray(theta)))
    )


def test_pack_unpack_roundtrip_matches():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=(2, 5, 256)).astype(np.uint32)
    ref = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    got = torb.pack_bits(_t(bits))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(torb.unpack_bits(got).numpy(), bits)
    np.testing.assert_array_equal(
        torb.to_signs(got).numpy(), np.asarray(jorb.to_signs(jnp.asarray(ref), jnp.float32))
    )
