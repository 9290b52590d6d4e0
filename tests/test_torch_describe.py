"""Port parity: rBRIEF descriptors of semantic_slam_master_tpu_torch
against the JAX package's ``describe_matmul`` and ``describe_gather`` on
the CPU, for the same blurred level image and keypoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.ops import fast as jfast
from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu_torch.ops import orb as torb


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(240, 320), (200, 288), (120, 160)])
def test_describe_bit_identical(shape):
    """Same blurred level image and keypoints -> the port's packed words
    equal JAX's describe_matmul and describe_gather bit for bit."""
    H, W = shape
    seq = synthetic.make_sequence(num_frames=2, scale=0.5)
    rgb = np.stack([seq.frame(i)["rgb"] for i in range(2)]).astype(np.float32)
    gray = jnp.asarray(rgb[:, :H, :W] @ np.array([0.299, 0.587, 0.114], np.float32))
    kp = jax.jit(lambda g: jfast.detect(g, 120, 0.05, 3, subpixel=True))(gray)
    blurred = jimage.gaussian_blur(gray, sigma=2.0, radius=3)
    ref_m = np.asarray(jax.jit(lambda b, x: jorb.describe_matmul(b, x, prefiltered=True))(blurred, kp.xy))
    ref_g = np.asarray(jax.jit(lambda b, x: jorb.describe_gather(b, x, prefiltered=True))(blurred, kp.xy))
    got = torb.describe(_t(blurred), _t(kp.xy), prefiltered=True).numpy()
    np.testing.assert_array_equal(got, ref_m.astype(np.int64))
    np.testing.assert_array_equal(got, ref_g.astype(np.int64))
