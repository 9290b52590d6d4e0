"""Port parity on the CPU for the semantic weight maps of the ORB path:
``extract_features`` with the segmenter's 1/4-resolution map (nearest
resized to every pyramid level, sampled with the pixel-centre rescale),
and ``detect(score_weight=...)``, bit-identical given JAX's own level
image and weight map. Tolerances as in tests/test_torch_learned_slam.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.ops import fast as jfast
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.ops import fast as tfast
from semantic_slam_master_tpu_torch.ops import image as timage
from semantic_slam_master_tpu_torch.slam import tracking as ttracking



def check_weighted(got, ref):
    """>= 98% of the keypoints coincide within 1e-3 px, their semantic
    weights are identical and >= 99% of their descriptors too."""
    got = convert.frame_features_to_numpy(got)
    coincide = (np.abs(got["xy"] - ref.xy).max(-1) <= 1e-3) & (got["valid"] == ref.valid)
    assert coincide[ref.valid].mean() >= 0.98, coincide[ref.valid].mean()
    np.testing.assert_array_equal(got["sem_weight"][coincide], np.asarray(ref.sem_weight)[coincide])
    assert (got["desc"] == np.asarray(ref.desc)).all(-1)[coincide].mean() >= 0.99


@pytest.fixture(scope="module")
def dynamic_frames():
    seq = synthetic.make_dynamic_sequence(num_frames=6, scale=0.5)
    fr = [seq.frame(i) for i in (0, 5)]
    rgb = np.stack([f["rgb"] for f in fr]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in fr]).astype(np.float32)
    labels = np.stack([f["labels"] for f in fr])
    return seq, rgb, gray, depth, labels


def test_extract_features_with_quarter_res_weight_map(dynamic_frames):
    """The segmenter's 1/4-resolution map: nearest-resized to each level,
    sampled with the pixel-centre rescale."""
    _, _, gray, depth, labels = dynamic_frames
    wmap = np.asarray(jseg.class_weights_map(jnp.asarray(labels[:2, 2::4, 2::4])))
    g, d = gray[:2], depth[:2]
    ref = jax.device_get(jax.jit(
        lambda a, b, w: jtracking.extract_features(a, b, num_keypoints=400, weight_map=w)
    )(jnp.asarray(g), jnp.asarray(d), jnp.asarray(wmap)))
    got = ttracking.extract_features(torch.from_numpy(g), torch.from_numpy(d), num_keypoints=400,
                                     weight_map=torch.from_numpy(wmap))
    check_weighted(got, ref)
    assert (got.sem_weight < 1.0).any() and (got.sem_weight == 1.0).any()


def test_detect_with_score_weight_is_exact(dynamic_frames):
    """Given the same level image and weight map, detection is bit-identical."""
    _, _, gray, _, labels = dynamic_frames
    wmap = np.asarray(jseg.class_weights_map(jnp.asarray(labels[:2])))
    w_lvl = np.asarray(jax.image.resize(jnp.asarray(wmap), (2, 200, 288), "nearest"))
    img = np.asarray(jax.image.resize(jnp.asarray(gray[:2]), (2, 200, 288), "bilinear"))
    np.testing.assert_array_equal(timage.resize_nearest(torch.from_numpy(wmap), 200, 288).numpy(), w_lvl)
    ref = jax.device_get(jax.jit(
        lambda a, w: jfast.detect(a, 150, 0.05, 3, subpixel=True, score_weight=w)
    )(jnp.asarray(img), jnp.asarray(w_lvl)))
    got = tfast.detect(torch.from_numpy(img), 150, 0.05, 3, subpixel=True, score_weight=torch.from_numpy(w_lvl))
    np.testing.assert_array_equal(got.xy.numpy(), ref.xy)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_allclose(got.score.numpy(), ref.score, rtol=0, atol=1e-5)
