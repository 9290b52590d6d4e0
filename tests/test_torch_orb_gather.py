"""Port parity of the ORB gather path (``ops/orb.py``: ``describe`` with the
JAX signature and dispatch, ``describe_gather``, ``describe_from_patches``,
``orientations``, ``orientations_dense``, ``dense_moment_maps``,
``set_test_pattern``) against the JAX package on the CPU, and the fault it
closes: ``extract_features`` on frames whose pyramid reaches the 24x32
floor, where the port's aligned gather alone refused the level.

Tolerances, and why: descriptors, steering offsets and moment maps of
quantised images are integers or exact integer sums, so they are held bit
for bit. On unquantised float images: the dense moment maps add in the
same order as JAX's, so they and the orientations read from them agree
within 1e-5 (relative, and rad: ``atan2`` is each library's own); the
patch orientation is a 961-term f32 product summed in each library's own
order (moments up to ~1e3, f32 steps of ~1e-4), so within 1e-4 rad.
Through the pyramid the levels are an ulp off JAX's (the resize
arithmetic, ROADMAP Queue 3), so ``extract_features`` keypoints agree
within 1e-3 px and >= 99% of descriptors are identical, as in
tests/test_torch_frontend.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu.ops import sampling as jsampling
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch.ops import image as timage
from semantic_slam_master_tpu_torch.ops import orb as torb
from semantic_slam_master_tpu_torch.ops import sampling as tsampling
from semantic_slam_master_tpu_torch.slam import tracking as ttracking


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (six test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _img(seed, B, H, W):
    return np.random.default_rng(seed).random((B, H, W), dtype=np.float32)


def _xy(seed, B, N, lo, hi, integer=False):
    xy = np.random.default_rng(seed).uniform(lo, hi, size=(B, N, 2)).astype(np.float32)
    return np.round(xy) if integer else xy


def _words(desc):
    return np.asarray(desc).astype(np.int64)


def test_extract_features_on_a_small_frame_matches_jax():
    """The fault: a (1, 48, 64) frame's pyramid ends at 24x32 levels, which
    JAX describes through ``describe_gather``; the port raised there."""
    g = _img(0, 1, 48, 64)
    d = np.ones_like(g)
    ref = jax.device_get(jtracking.extract_features(jnp.asarray(g), jnp.asarray(d), num_keypoints=64))
    got = ttracking.extract_features(_t(g), _t(d), num_keypoints=64)
    assert got.xy.shape == (1, 64, 2) and got.desc.shape == (1, 64, 8)
    assert np.abs(got.xy.numpy() - ref.xy).max() <= 1e-3
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.depth.numpy(), ref.depth)
    assert (got.desc.numpy() == _words(ref.desc)).all(-1).mean() >= 0.99


@pytest.mark.parametrize("shape", [(24, 32), (32, 32), (32, 64), (24, 64), (48, 80), (120, 100), (24, 50)])
def test_describe_matches_jax_at_every_frame_size(shape):
    """``describe`` (blur included) and ``describe_gather`` against JAX's
    bit for bit, keypoints in and around the frame: the crossed centre
    clamp below 32x33 ((24, 32), (32, 32), (24, 50)), JAX's matmul path
    with clamped rows ((24, 64)), and interior frames of odd widths."""
    H, W = shape
    img = _img(1, 2, H, W)
    xy = _xy(2, 2, 24, -5.0, max(H, W) + 5.0)
    xy[0, 0] = [np.nan, 3.0]
    ref = _words(jorb.describe(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_array_equal(torb.describe(_t(img), _t(xy)).numpy(), ref)
    ref_g = _words(jorb.describe_gather(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_array_equal(torb.describe_gather(_t(img), _t(xy)).numpy(), ref_g)


def test_describe_with_given_theta_and_prefiltered():
    img = _img(3, 2, 96, 128)
    xy = _xy(4, 2, 16, 20.0, 90.0)
    theta = np.random.default_rng(5).uniform(-7.0, 7.0, size=(2, 16)).astype(np.float32)
    ref = _words(jorb.describe(jnp.asarray(img), jnp.asarray(xy), theta=jnp.asarray(theta), prefiltered=True))
    np.testing.assert_array_equal(torb.describe(_t(img), _t(xy), theta=_t(theta), prefiltered=True).numpy(), ref)
    ref_b = _words(jorb.describe(jnp.asarray(img), jnp.asarray(xy), blur_sigma=1.0))
    np.testing.assert_array_equal(torb.describe(_t(img), _t(xy), blur_sigma=1.0).numpy(), ref_b)


@pytest.mark.parametrize("case", ["integer", "subpixel", "block_edges"])
def test_aligned_and_gather_paths_agree(case):
    """The cases of tests/test_orb_matmul.py: with a shared orientation the
    aligned path and ``describe_gather`` give the same bits, and equal
    JAX's ``describe_gather``."""
    if case == "block_edges":
        img = _img(6, 1, 64, 160)
        xs = [17.0, 31.0, 32.0, 33.0, 47.0, 63.0, 64.0, 95.0, 96.0, 127.0, 130.0, 141.0]
        xy = np.asarray([[[x, 32.0] for x in xs]], np.float32)
    else:
        img = _img(6, 2, 96, 128)
        xy = _xy(7, 2, 24, 20.0, 90.0, integer=case == "integer")
    theta = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    aligned = torb.describe(_t(img), _t(xy), theta=_t(theta), prefiltered=True).numpy()
    gathered = torb.describe_gather(_t(img), _t(xy), theta=_t(theta), prefiltered=True).numpy()
    np.testing.assert_array_equal(aligned, gathered)
    ref = jorb.describe_gather(jnp.asarray(img), jnp.asarray(xy), theta=jnp.asarray(theta), prefiltered=True)
    np.testing.assert_array_equal(gathered, _words(ref))
    # Full pipeline: each path's own orientation (patch moments against
    # dense moment maps of the quantised frame) gives the same bits.
    np.testing.assert_array_equal(torb.describe(_t(img), _t(xy), prefiltered=True).numpy(),
                                  torb.describe_gather(_t(img), _t(xy), prefiltered=True).numpy())


def test_describe_from_patches_matches_jax():
    """tests/test_orb_dense.py's cases: descriptors from radius-15 windows
    (the port's ``gather_patches``) equal the direct path, and 32x32
    padded windows give the same bits."""
    img = _img(8, 2, 96, 128)
    xy = _xy(9, 2, 16, 32.0, 64.0, integer=True)
    jtheta = jorb.orientations(jnp.asarray(img), jnp.asarray(xy))
    jpatches = jsampling.gather_patches(jnp.asarray(img), jnp.asarray(xy), 15)
    ref = _words(jorb.describe_from_patches(jpatches, theta=jtheta))
    patches = tsampling.gather_patches(_t(img), _t(xy), 15)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jpatches))
    theta = _t(jtheta)
    got = torb.describe_from_patches(patches, theta=theta).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, torb.describe(_t(img), _t(xy), theta=theta, prefiltered=True).numpy())
    padded = torch.nn.functional.pad(patches, (0, 1, 0, 1))
    np.testing.assert_array_equal(torb.describe_from_patches(padded, theta=theta).numpy(), got)
    # Without theta: the orientation of the quantised window.
    np.testing.assert_array_equal(torb.describe_from_patches(patches).numpy(),
                                  _words(jorb.describe_from_patches(jpatches)))


def test_orientations_match_jax():
    img = _img(10, 2, 96, 128)
    xy = _xy(11, 2, 20, 32.0, 64.0)
    ref = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    got = torb.orientations(_t(img), _t(xy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    ref_d = np.asarray(jorb.orientations_dense(jnp.asarray(img), jnp.asarray(xy)))
    got_d = torb.orientations_dense(_t(img), _t(xy)).numpy()
    np.testing.assert_allclose(got_d, ref_d, rtol=0, atol=1e-5)
    # Dense maps sampled at interior points equal the patch moments.
    np.testing.assert_allclose(got_d, got, rtol=0, atol=1e-3)


@pytest.mark.parametrize("quantised", [False, True])
def test_dense_moment_maps_match_jax(quantised):
    img = _img(12, 2, 40, 52)
    if quantised:
        img = np.round(img * 255.0)
    ref = [np.asarray(m) for m in jorb.dense_moment_maps(jnp.asarray(img))]
    got = [m.numpy() for m in torb.dense_moment_maps(_t(img))]
    for g, r in zip(got, ref):
        if quantised:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dy,dx", [(0, 3), (-2, 0), (4, -5), (0, 0)])
def test_shift2d_matches_jax(dy, dx):
    img = _img(13, 2, 9, 11)
    np.testing.assert_array_equal(timage.shift2d(_t(img), dy, dx).numpy(),
                                  np.asarray(jimage.shift2d(jnp.asarray(img), dy, dx)))


def test_steered_offsets_match_jax():
    theta = np.concatenate([np.linspace(-10, 10, 401), [0.0, np.pi, -np.pi, 2 * np.pi]]).astype(np.float32)
    np.testing.assert_array_equal(torb._steered_offsets(_t(theta[None])).numpy(),
                                  np.asarray(jorb._steered_offsets(jnp.asarray(theta[None]))).astype(np.int64))


def test_set_test_pattern_swaps_and_restores():
    """tests/test_orb.py's case, on both packages: another pattern changes
    the descriptors, to JAX's for that pattern; the default restores them."""
    img = _img(14, 1, 64, 64)
    xy = _xy(15, 1, 16, 20.0, 44.0)
    other = jorb.make_test_pattern(seed=99)
    d0 = torb.describe(_t(img), _t(xy), prefiltered=True).numpy()
    try:
        jorb.set_test_pattern(other)
        torb.set_test_pattern(other)
        ref = _words(jorb.describe(jnp.asarray(img), jnp.asarray(xy), prefiltered=True))
        d1 = torb.describe(_t(img), _t(xy), prefiltered=True).numpy()
        d1_gather = torb.describe_gather(_t(img), _t(xy), prefiltered=True).numpy()
    finally:
        jorb.set_test_pattern(jorb.make_test_pattern())
        torb.set_test_pattern(torb.DEFAULT_PATTERN)
        jax.clear_caches()
    np.testing.assert_array_equal(d1, ref)
    np.testing.assert_array_equal(d1_gather, ref)
    assert not np.array_equal(d0, d1)
    np.testing.assert_array_equal(torb.describe(_t(img), _t(xy), prefiltered=True).numpy(), d0)
    with pytest.raises(ValueError, match="256, 4"):
        torb.set_test_pattern(np.zeros((3, 4), np.int8))
    with pytest.raises(ValueError, match="within"):
        torb.set_test_pattern(np.full((256, 4), 16, np.int8))
