"""Port parity: FAST-9 response and detection of semantic_slam_master_tpu_torch
against the JAX package (XLA stencil and the Pallas kernel in interpret
mode) on the CPU, where the port's wrapper runs the kernel's plain
version. The CUDA kernel itself is held against that plain version on
the card (tests/test_torch_kernels_gpu.py and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.ops import fast as jfast
from semantic_slam_master_tpu.ops.pallas import fast_score as jpfs
from semantic_slam_master_tpu_torch.ops import fast as tfast
from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gray():
    """Two 240x320 synthetic gray frames."""
    seq = synthetic.make_sequence(num_frames=2, scale=0.5)
    rgb = np.stack([seq.frame(i)["rgb"] for i in range(2)]).astype(np.float32)
    return (rgb @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.float32)


def test_circle_matches():
    np.testing.assert_array_equal(np.array(kfast.FAST_CIRCLE), jfast.FAST_CIRCLE)
    assert kfast.BORDER_MARGIN == jfast.BORDER_MARGIN


@pytest.mark.parametrize("width", [320, 300, 257])
@pytest.mark.parametrize("threshold", [0.05, 0.08])
def test_fast_score_matches_xla(gray, width, threshold):
    g = gray[:, :, :width]
    ref = np.asarray(jfast.fast_score_xla(jnp.asarray(g), threshold))
    got = tfast.fast_score(_t(g), threshold).numpy()
    # Decisions are exact; scores differ only by the f32 summation order
    # of the 16 margins (the port adds in circle order).
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("width", [320, 300])
def test_fast_score_matches_pallas_interior(gray, width):
    g = gray[:, :, :width]
    ref = np.asarray(jpfs.fast_score_pallas(jnp.asarray(g), 0.05, interpret=True))
    got = tfast.fast_score(_t(g), 0.05).numpy()
    inner = (slice(None), slice(4, -4), slice(4, -4))
    np.testing.assert_array_equal(got[inner] > 0, ref[inner] > 0)
    np.testing.assert_allclose(got[inner], ref[inner], atol=1e-5, rtol=0)


def test_fast_score_rejects_bad_input():
    with pytest.raises(TypeError):
        kfast.fast_score(torch.zeros((1, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        kfast.fast_score(torch.zeros((8, 8)))


@pytest.mark.parametrize("shape", [(240, 320), (200, 272), (120, 160), (83, 302)])
@pytest.mark.parametrize("subpixel", [False, True])
def test_detect_matches(gray, shape, subpixel):
    H, W = shape
    g = gray[:, :H, :W]
    k = 150
    ref = jax.jit(
        lambda x: jfast.detect(x, k, 0.05, 3, subpixel=subpixel)
    )(jnp.asarray(g))
    got = tfast.detect(_t(g), k, 0.05, 3, subpixel=subpixel)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), atol=1e-5, rtol=0)
    assert got.valid.sum() > 20
