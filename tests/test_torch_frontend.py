"""Port parity: the multi-scale ORB frontend (``extract_features``) of
semantic_slam_master_tpu_torch against the JAX package on synthetic
frames, on the CPU.

The pyramid levels agree with JAX's to an ulp or two (XLA compiles the
resize weights with its own fused multiply-adds), not bit for bit. That
moves the sub-pixel refinement of some keypoints by a small fraction of
a pixel (their xy are not bit-identical) and could move
a FAST decision sitting exactly on the threshold. So a keypoint
"coincides" when its slot holds the same detection within 1e-3 px;
>= 98% must coincide, with descriptors, depth and validity identical
where they do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.slam import tracking as ttracking


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.make_sequence(num_frames=4, scale=0.5)
    fr = [seq.frame(i) for i in range(4)]
    rgb = np.stack([f["rgb"] for f in fr]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in fr]).astype(np.float32)
    ref = jax.jit(lambda g, d: jtracking.extract_features(g, d, num_keypoints=400))(
        jnp.asarray(gray), jnp.asarray(depth)
    )
    got = ttracking.extract_features(torch.from_numpy(gray), torch.from_numpy(depth), num_keypoints=400)
    return jax.device_get(ref), got


def test_pyramid_shapes_and_quotas_match():
    shapes = ttracking.pyramid_shapes(480, 640, 4)
    assert shapes == [(480, 640), (400, 544), (336, 448), (280, 384)]
    assert list(ttracking.level_quotas(shapes, 512)) == [202, 142, 98, 70]


def test_extract_features_keypoints_coincide(frames):
    ref, got = frames
    got = convert.frame_features_to_numpy(got)
    jxy, jvalid = np.asarray(ref.xy), np.asarray(ref.valid)
    coincide = (np.abs(got["xy"] - jxy).max(-1) <= 1e-3) & (got["valid"] == jvalid)
    for f in range(jxy.shape[0]):
        share = coincide[f][jvalid[f]].mean()
        assert jvalid[f].sum() > 150 and share >= 0.98, (f, share)
    np.testing.assert_array_equal(got["desc"][coincide], np.asarray(ref.desc)[coincide])
    np.testing.assert_array_equal(got["depth"][coincide], np.asarray(ref.depth)[coincide])
    np.testing.assert_array_equal(got["valid"][coincide], jvalid[coincide])
    np.testing.assert_allclose(got["score"][coincide], np.asarray(ref.score)[coincide], atol=1e-5)
    assert got["desc"].dtype == np.uint32


def test_extract_features_bit_identical_given_jax_levels(frames):
    """With JAX's own pyramid levels as input, the port's per-level
    detection and description equal JAX's bit for bit: the only gap in
    the frontend is the resize arithmetic."""
    from semantic_slam_master_tpu.ops import fast as jfast
    from semantic_slam_master_tpu.ops import image as jimage
    from semantic_slam_master_tpu.ops import orb as jorb
    from semantic_slam_master_tpu_torch.ops import fast as tfast
    from semantic_slam_master_tpu_torch.ops import image as timage
    from semantic_slam_master_tpu_torch.ops import orb as torb

    seq = synthetic.make_sequence(num_frames=2, scale=0.5)
    rgb = np.stack([seq.frame(i)["rgb"] for i in range(2)]).astype(np.float32)
    gray = jnp.asarray(rgb @ np.array([0.299, 0.587, 0.114], np.float32))
    levels = jax.jit(lambda g: jtracking.build_pyramid(g, 4))(gray)
    quotas = ttracking.level_quotas([lv.shape[1:] for lv in levels], 400)

    def jax_level(img, quota):
        kp = jfast.detect(img, quota, 0.05, 3, subpixel=True)
        blurred = jimage.gaussian_blur(img, sigma=2.0, radius=3)
        return kp, jorb.describe(blurred, kp.xy, prefiltered=True)

    for img, quota in zip(levels, quotas):
        jkp, jdesc = jax.jit(jax_level, static_argnums=1)(img, int(quota))
        t = torch.from_numpy(np.array(img))
        tkp = tfast.detect(t, int(quota), 0.05, 3, subpixel=True)
        tdesc = torb.describe(timage.gaussian_blur(t, sigma=2.0, radius=3), tkp.xy, prefiltered=True)
        np.testing.assert_array_equal(tkp.xy.numpy(), np.asarray(jkp.xy))
        np.testing.assert_array_equal(tkp.valid.numpy(), np.asarray(jkp.valid))
        np.testing.assert_array_equal(tdesc.numpy(), np.asarray(jdesc).astype(np.int64))
