"""Port parity: the learned frontend's modules and the segmenter of
semantic_slam_master_tpu_torch against the flax modules of the JAX
package, on the CPU, at the tests' small width (``tiny_frontend``) with
random weights converted by ``convert.py``.

Tolerances, and why:
- f32 models: sums run in another order than XLA's (matmul blocking,
  mean reductions), so floats agree to ~1e-6 relative; keypoints agree
  slot by slot within 1e-3 px, and ``select_keypoints`` given JAX's own
  saliency is exact (its tie order is ``lax.top_k``'s).
- bf16 models: the two frameworks round to bf16 at other points (fused
  matmul epilogues, GELU in f32 or bf16), ~2^-8 relative per rounding, so
  the backbone features differ by a few per cent of their range, and a
  keypoint whose rank is near a tie can change its slot. Saliency is
  compared within 0.01, keypoints as sets (each JAX keypoint has a port
  keypoint within 0.05 px for >= 95% of them), descriptors by cosine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.models import frontend as jfrontend
from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.models import selector as jselector
from semantic_slam_master_tpu.ops import matching as jmatching
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.core.fixed import quantile
from semantic_slam_master_tpu_torch.models import backbone as tbackbone
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.models import segmenter as tseg
from semantic_slam_master_tpu_torch.models import selector as tselector
from semantic_slam_master_tpu_torch.ops import image as timage
from semantic_slam_master_tpu_torch.ops import matching as tmatching
from semantic_slam_master_tpu_torch.ops.sampling import bilinear_sample

H, W = 64, 96  # a 4x6 patch grid against pos_grid 8: the pos-embed resize runs
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _random_variables(variables, seed):
    """Every parameter drawn afresh (the zero-initialised offset-head conv
    and the identity BatchNorm included), so no layer is trivially exact."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: rng.normal(0.0, 0.3, size=a.shape).astype(np.float32), variables)
    bn = out["batch_stats"]["backbone"]["feature_norm"]
    bn["var"] = np.abs(bn["var"]) + 0.5
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(DTYPES))
def frontend_pair(request, images):
    jdt, tdt = DTYPES[request.param]
    jm = jfrontend.tiny_frontend(subpatch_refine=True, dtype=jdt)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    variables = _random_variables(jax.device_get(variables), 1)
    ref = jax.device_get(jax.jit(lambda x: jm.apply(variables, x))(jnp.asarray(images)))
    tm = tfrontend.tiny_frontend(subpatch_refine=True, dtype=tdt)
    tm.load_state_dict(convert.frontend_state_dict(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    return request.param, jm, variables, tm, ref, got


def test_backbone_features(frontend_pair):
    name, _, _, _, ref, got = frontend_pair
    scale = np.abs(ref.features).max()
    err = np.abs(got.features.numpy() - ref.features).max()
    assert err <= (2e-6 if name == "f32" else 0.03) * scale, (err, scale)


def test_selector_given_jax_features(frontend_pair):
    _, _, _, tm, ref, _ = frontend_pair
    with torch.no_grad():
        sal = tm.selector(torch.from_numpy(ref.features.copy())).numpy()
    np.testing.assert_allclose(sal, ref.saliency, rtol=0, atol=1e-6)


def test_saliency(frontend_pair):
    name, _, _, _, ref, got = frontend_pair
    err = np.abs(got.saliency.numpy() - ref.saliency).max()
    assert err <= (1e-6 if name == "f32" else 0.01), err


def test_select_keypoints_exact_given_jax_saliency(frontend_pair):
    _, _, _, _, ref, _ = frontend_pair
    for k in (24, 64):
        j = jselector.select_keypoints(jnp.asarray(ref.saliency), num_keypoints=k)
        t = tselector.select_keypoints(torch.from_numpy(ref.saliency), num_keypoints=k)
        np.testing.assert_array_equal(t.xy.numpy(), np.asarray(j.xy))
        np.testing.assert_array_equal(t.score.numpy(), np.asarray(j.score))
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


@pytest.mark.parametrize("levels", [4, 16, 1000])
def test_select_keypoints_exact_with_ties(levels):
    """Saliency on a coarse grid of values ties many patches in score and
    in tier; the selection order must still equal JAX's."""
    rng = np.random.default_rng(levels)
    sal = (np.round(rng.random((3, 30, 40, 1)) * levels) / levels).astype(np.float32)
    for k in (100, 500, 1300):
        j = jselector.select_keypoints(jnp.asarray(sal), num_keypoints=k)
        t = tselector.select_keypoints(torch.from_numpy(sal), num_keypoints=k)
        np.testing.assert_array_equal(t.xy.numpy(), np.asarray(j.xy))
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def test_keypoints(frontend_pair):
    name, _, _, _, ref, got = frontend_pair
    a, b = ref.keypoints_px, got.keypoints_px.numpy()
    if name == "f32":
        assert np.abs(a - b).max() <= 1e-3
        return
    nearest = np.sqrt(((a[:, :, None] - b[:, None]) ** 2).sum(-1)).min(-1)
    assert (nearest <= 0.05).mean() >= 0.95, (nearest <= 0.05).mean()


def test_refiner_and_estimator_given_jax_keypoints(frontend_pair):
    """The descriptor refiner and the confidence head on JAX's features at
    JAX's keypoints (f32 heads in both dtypes)."""
    _, _, _, tm, ref, _ = frontend_pair
    with torch.no_grad():
        _, desc, conf = tm.describe_at(torch.from_numpy(ref.features), torch.from_numpy(ref.keypoints_patch))
    np.testing.assert_allclose(desc.numpy(), ref.descriptors, rtol=0, atol=2e-6)
    np.testing.assert_allclose(conf.numpy(), ref.confidence, rtol=0, atol=2e-6)


def test_offset_head(frontend_pair):
    """The offset head runs in f32 in both dtypes."""
    _, jm, variables, tm, _, _ = frontend_pair
    rng = np.random.default_rng(3)
    P = 21
    patch = rng.normal(size=(2, 5, P, P)).astype(np.float32)
    local = rng.normal(size=(2, 5, 64)).astype(np.float32)
    sal = rng.random((2, 5, 9)).astype(np.float32)
    ref = jax.jit(
        lambda p, l, s: jm.apply(variables, p, l, s, method=lambda m, *a: m.offset_head(*a))
    )(patch, local, sal)
    with torch.no_grad():
        got = tm.offset_head(torch.from_numpy(patch), torch.from_numpy(local), torch.from_numpy(sal))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_descriptors_and_confidence(frontend_pair):
    name, _, _, _, ref, got = frontend_pair
    if name == "f32":
        np.testing.assert_allclose(got.descriptors.numpy(), ref.descriptors, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.confidence.numpy(), ref.confidence, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
        return
    # bf16: compare where the slot holds the same keypoint.
    same = np.abs(got.keypoints_px.numpy() - ref.keypoints_px).max(-1) <= 0.05
    cos = (got.descriptors.numpy() * ref.descriptors).sum(-1)
    assert same.mean() >= 0.5 and cos[same].min() >= 0.95, (same.mean(), cos[same].min())


@pytest.fixture(scope="module", params=list(DTYPES))
def segmenter_pair(request, images):
    jdt, tdt = DTYPES[request.param]
    rgb = np.abs(images) / np.abs(images).max()
    jm = jseg.SemanticSegmenter(dtype=jdt)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(rgb))["params"])
    ref4, ref = jax.jit(
        lambda x: (jm.apply({"params": params}, x, full_res=False), jm.apply({"params": params}, x))
    )(jnp.asarray(rgb))
    tm = tseg.SemanticSegmenter(dtype=tdt)
    tm.load_state_dict(convert.segmenter_state_dict({"params": params}))
    with torch.no_grad():
        got4, got = tm(torch.from_numpy(rgb), full_res=False), tm(torch.from_numpy(rgb))
    return request.param, np.asarray(ref4), np.asarray(ref), got4.numpy(), got.numpy()


def test_segmenter(segmenter_pair):
    name, ref4, ref, got4, got = segmenter_pair
    assert got4.shape == (2, H // 4, W // 4, 6) and got.shape == (2, H, W, 6)
    scale = np.abs(ref4).max()
    tol = 2e-5 if name == "f32" else 0.05
    assert np.abs(got4 - ref4).max() <= tol * scale
    assert np.abs(got - ref).max() <= tol * scale
    agree = (got4.argmax(-1) == ref4.argmax(-1)).mean()
    assert agree >= (1.0 if name == "f32" else 0.98), agree


def test_keypoint_semantic_weights_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, size=(2, 30, 40))
    xy = rng.uniform(-3, 125, size=(2, 50, 2)).astype(np.float32)
    ref = jseg.keypoint_semantic_weights(jnp.asarray(labels), jnp.asarray(xy), image_size=(120, 160))
    got = tseg.keypoint_semantic_weights(torch.from_numpy(labels), torch.from_numpy(xy), image_size=(120, 160))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("src", [(120, 160), (480, 640)])
def test_resize_nearest_matches_jax(src):
    rng = np.random.default_rng(src[0])
    x = rng.random((2,) + src).astype(np.float32)
    for h, w in [(480, 640), (400, 544), (336, 448), (280, 384), (120, 160)]:
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, h, w), "nearest"))
        np.testing.assert_array_equal(timage.resize_nearest(torch.from_numpy(x), h, w).numpy(), ref)


def test_resize_bilinear_nhwc_matches_jax():
    """Upsampling weights agree with XLA's compiled ones to an ulp."""
    rng = np.random.default_rng(6)
    for shape, (h, w) in [((1, 28, 28, 16), (30, 40)), ((2, 15, 20, 8), (30, 40))]:
        x = rng.normal(size=shape).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], h, w, shape[3]), "bilinear"))
        got = timage.resize_bilinear_nhwc(torch.from_numpy(x), h, w).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_quantile_exact():
    rng = np.random.default_rng(7)
    for n in (7, 64, 1200):
        x = rng.random((4, n)).astype(np.float32)
        for q in (0.5, 0.4, 0.3, 0.2, 0.1):
            ref = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1, method="linear"))
            np.testing.assert_array_equal(quantile(torch.from_numpy(x), q).numpy(), ref)


def test_match_cosine_matches_jax():
    rng = np.random.default_rng(8)
    d1 = rng.normal(size=(120, 32)).astype(np.float32)
    d2 = np.concatenate([d1[:60] + 0.05 * rng.normal(size=(60, 32)), rng.normal(size=(80, 32))]).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1, v2 = rng.random(120) > 0.1, rng.random(140) > 0.1
    for ratio, min_sim in ((0.9, None), (None, 0.6)):
        j = jmatching.match_cosine(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
                                   ratio=ratio, min_similarity=min_sim)
        t = tmatching.match_cosine(torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(v1),
                                   torch.from_numpy(v2), ratio=ratio, min_similarity=min_sim)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        np.testing.assert_array_equal(t.idx2.numpy()[t.valid.numpy()], np.asarray(j.idx2)[np.asarray(j.valid)])
        assert t.valid.sum() >= 40


def test_patch_pixel_converters_and_bilinear_on_features(frontend_pair):
    _, _, _, _, ref, _ = frontend_pair
    kp = torch.from_numpy(ref.keypoints_patch)
    np.testing.assert_allclose(tbackbone.pixel_to_patch(tbackbone.patch_to_pixel(kp)).numpy(), ref.keypoints_patch, atol=1e-6)
    np.testing.assert_array_equal(tbackbone.patch_to_pixel(kp).numpy(), ref.keypoints_px)
    assert bilinear_sample(torch.from_numpy(ref.features), kp).shape == (2, 64, 64)
