"""Port parity of the training losses: ``losses/self_supervised.py``,
the uncertainty head's and the segmenter's losses, the image ops the edge
loss uses and ``matches_to_pairs``, each against the JAX function on the
same numpy inputs (drawn from a seed), at f32 on the CPU, values and
gradients with respect to every float input.

Tolerances, and why: the two packages sum in other orders (XLA's fused
reductions and dot products against PyTorch's), so values agree within
1e-5 relative and gradients within 1e-5 of the largest gradient entry;
integer outputs (pairs, validity) are exact. Every input is drawn so no
loss hits an exact tie at a hinge or clip edge, except where a test says
it ties on purpose (``test_mutual_score_gradient_splits_tied_maxima``:
``jnp.max`` splits a tied maximum's gradient evenly, as ``torch.amax``
does and ``max(dim).values`` does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.losses import self_supervised as jl
from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.models import uncertainty as junc
from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu.ops import matching as jmatching
from semantic_slam_master_tpu_torch.losses import self_supervised as tl
from semantic_slam_master_tpu_torch.models import segmenter as tseg
from semantic_slam_master_tpu_torch.models import uncertainty as tunc
from semantic_slam_master_tpu_torch.ops import image as timage
from semantic_slam_master_tpu_torch.ops import matching as tmatching


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread. Six test workers, each with one
    OpenMP thread per core, otherwise spin against each other (a 0.8 s
    test here took 70 s in the full parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
B, N, D, P = 3, 20, 8, 20


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _check(jfn, tfn, float_args, other=(), rtol=RTOL):
    """Values and gradients (of the sum of the outputs) of jfn and tfn on
    the same inputs; ``other`` are non-differentiable inputs (numpy)."""
    jargs = [jnp.asarray(a) for a in float_args]
    jo = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in other]

    def jtotal(*xs):
        out = jfn(*xs, *jo)
        return sum(jnp.sum(o) for o in (out if isinstance(out, tuple) else (out,)))

    jval = jfn(*jargs, *jo)
    jgrads = jax.grad(jtotal, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in float_args]
    to = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in other]
    tval = tfn(*targs, *to)
    touts = tval if isinstance(tval, tuple) else (tval,)
    sum(o.sum() for o in touts).backward()
    for j, t in zip(jval if isinstance(jval, tuple) else (jval,), touts):
        j = np.asarray(j)
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1e-3))
    for jg, ta in zip(jgrads, targs):
        jg = np.asarray(jg)
        tg = ta.grad.numpy() if ta.grad is not None else np.zeros_like(jg)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=rtol * max(np.abs(jg).max(), 1e-6))
    return jval, tval


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    desc1 = _unit(rng.normal(size=(B, N, D)))
    desc2 = _unit(desc1 + 0.3 * rng.normal(size=(B, N, D)))
    pairs = np.stack([np.tile(np.arange(P), (B, 1)), rng.permutation(np.tile(np.arange(N), (B, 1)).T).T[:, :P]],
                     axis=-1).astype(np.int64)
    pair_valid = rng.random((B, P)) < 0.6
    pair_valid[1] = False  # one image without pairs
    sal1 = rng.random((B, 6, 8, 1)).astype(np.float32)
    sal2 = np.clip(sal1 + 0.1 * rng.normal(size=sal1.shape), 0, 1).astype(np.float32)
    rgb = rng.normal(size=(B, 96, 128, 3)).astype(np.float32)
    return dict(desc1=desc1, desc2=desc2, pairs=pairs, pair_valid=pair_valid, sal1=sal1, sal2=sal2, rgb=rgb,
                neg_ok=rng.random((B, P, N)) < 0.8, valid2=rng.random((B, N)) < 0.9, rng=rng)


def test_image_ops(data):
    gray = data["rgb"][..., 0]
    kernel = np.arange(15, dtype=np.float32).reshape(3, 5) - 7
    for pad in ("SAME", "VALID"):
        np.testing.assert_allclose(timage.conv2d_single(torch.from_numpy(gray), kernel, pad).numpy(),
                                   np.asarray(jimage.conv2d_single(jnp.asarray(gray), kernel, pad)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(timage.sobel_magnitude(torch.from_numpy(gray)).numpy(),
                               np.asarray(jimage.sobel_magnitude(jnp.asarray(gray))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(timage.avg_pool_to(torch.from_numpy(gray), 6, 8).numpy(),
                               np.asarray(jimage.avg_pool_to(jnp.asarray(gray), 6, 8)), rtol=1e-6, atol=1e-6)


def test_descriptor_matching_loss(data):
    d = data
    _check(lambda a, b, p, v: jl.descriptor_matching_loss(a, b, p, v, 0.1),
           lambda a, b, p, v: tl.descriptor_matching_loss(a, b, p, v, 0.1),
           [d["desc1"], d["desc2"]], [d["pairs"], d["pair_valid"]])


@pytest.mark.parametrize("cross_image", [True, False])
def test_descriptor_matching_loss_hard(data, cross_image):
    d = data
    _check(lambda a, b, p, v, n, v2: jl.descriptor_matching_loss_hard(a, b, p, v, n, v2, cross_image=cross_image),
           lambda a, b, p, v, n, v2: tl.descriptor_matching_loss_hard(a, b, p, v, n, v2, cross_image=cross_image),
           [d["desc1"], d["desc2"]], [d["pairs"], d["pair_valid"], d["neg_ok"], d["valid2"]])


@pytest.mark.parametrize("hard", [False, True])
def test_no_pair_fallback(data, hard):
    """No valid pair anywhere: the desc term is the 0.1 fallback (the hard
    margin 0), and no gradient reaches the descriptors through it."""
    d = data
    none = np.zeros_like(d["pair_valid"])
    if hard:
        jv, tv = _check(lambda a, b, p, v, n: jl.descriptor_matching_loss_hard(a, b, p, v, n),
                        lambda a, b, p, v, n: tl.descriptor_matching_loss_hard(a, b, p, v, n),
                        [d["desc1"], d["desc2"]], [d["pairs"], none, d["neg_ok"]])
        assert [float(x.detach()) for x in tv] == [float(x) for x in jv] == [pytest.approx(0.1), 0.0]
    else:
        jv, tv = _check(lambda a, b, p, v: jl.descriptor_matching_loss(a, b, p, v),
                        lambda a, b, p, v: tl.descriptor_matching_loss(a, b, p, v),
                        [d["desc1"], d["desc2"]], [d["pairs"], none])
        assert float(tv.detach()) == float(jv) == pytest.approx(0.1)


@pytest.mark.parametrize("masked", [False, True])
def test_descriptor_variance_and_decorrelation(data, masked):
    d = data
    if masked:
        _check(lambda a, v: jl.descriptor_variance_loss(a, v, min_variance=0.2),
               lambda a, v: tl.descriptor_variance_loss(a, v, min_variance=0.2), [d["desc1"]], [d["valid2"]])
    else:
        _check(lambda a: jl.descriptor_variance_loss(a, min_variance=0.2),
               lambda a: tl.descriptor_variance_loss(a, min_variance=0.2), [d["desc1"]])
        _check(jl.descriptor_decorrelation_loss, tl.descriptor_decorrelation_loss, [d["desc1"]])


def test_saliency_losses(data):
    d = data
    _check(jl.repeatability_loss, tl.repeatability_loss, [d["sal1"], d["sal2"]])
    _check(jl.peakiness_loss, tl.peakiness_loss, [d["sal1"]])
    _check(jl.activation_loss, tl.activation_loss, [d["sal1"]])
    _check(jl.spatial_sparsity_loss, tl.spatial_sparsity_loss, [d["sal1"] * 0.5])
    _check(jl.spatial_sparsity_loss, tl.spatial_sparsity_loss, [d["sal1"]])
    # The images carry no gradient in training (they are the input).
    _check(jl.edge_awareness_loss, tl.edge_awareness_loss, [d["sal1"]], [d["rgb"]])


def _geometry(rng, b=2, k=24, h=48, w=64):
    depth = (1.0 + 2.0 * rng.random((b, h, w))).astype(np.float32)
    depth[0, :5] = 0.0  # below min_depth: invalid warps
    K = np.array([[50.0, 0, 32.0], [0, 52.0, 24.0], [0, 0, 1]], np.float32)
    K2 = np.stack([K + np.array([[0, 0, 1.5], [0, 0, -2.0], [0, 0, 0]], np.float32)] * b)
    ang = 0.05 * rng.normal(size=(b,))
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 0, 0] = T[:, 1, 1] = np.cos(ang)
    T[:, 0, 1], T[:, 1, 0] = -np.sin(ang), np.sin(ang)
    T[:, :3, 3] = 0.05 * rng.normal(size=(b, 3))
    uv1 = (rng.random((b, k, 2)) * [w - 1, h - 1]).astype(np.float32) + 0.3
    uv2 = (uv1 + rng.normal(size=uv1.shape) * 3.0).astype(np.float32)
    return uv1, uv2, depth, K, K2, T


@pytest.mark.parametrize("safe", [None, 5.0])
def test_gt_match_pairs_exact(safe):
    rng = np.random.default_rng(1)
    uv1, uv2, depth, K, K2, T = _geometry(rng)
    v1, v2 = rng.random(uv1.shape[:2]) < 0.9, rng.random(uv2.shape[:2]) < 0.9
    j = jl.gt_match_pairs(*map(jnp.asarray, (uv1, uv2, v1, v2, depth, K, T)), K2=jnp.asarray(K2), radius=6.0,
                          safe_radius=safe)
    t = tl.gt_match_pairs(*map(torch.from_numpy, (uv1, uv2, v1, v2, depth, K, T)), K2=torch.from_numpy(K2),
                          radius=6.0, safe_radius=safe)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert 0 < int(np.asarray(j[1]).sum()) < j[1].size


@pytest.mark.parametrize("max_residual", [None, 5.0])
def test_localization_loss(max_residual):
    rng = np.random.default_rng(2)
    uv1, uv2, depth, K, K2, T = _geometry(rng)
    valid = rng.random(uv1.shape[:2]) < 0.8
    _check(lambda a, b, v, dep, k, t, k2: jl.localization_loss(a, b, v, dep, k, t, max_residual=max_residual, K2=k2),
           lambda a, b, v, dep, k, t, k2: tl.localization_loss(a, b, v, dep, k, t, max_residual=max_residual, K2=k2),
           [uv1, uv2], [valid, depth, K, T, K2])


@pytest.mark.parametrize("hard", [False, True])
def test_total_loss(data, hard):
    d = data
    extra = [d["neg_ok"], d["valid2"]] if hard else []

    def run(mod, a, b, s1, s2, p, v, rgb, *rest):
        kw = dict(neg_ok=rest[0], valid2=rest[1]) if rest else {}
        bundle = mod.total_loss(a, b, p, v, s1, s2, rgb, weights={"hard": 2.0}, **kw)
        return (bundle.total,) + tuple(bundle.components[k] for k in sorted(bundle.components))

    _check(lambda *x: run(jl, *x), lambda *x: run(tl, *x), [d["desc1"], d["desc2"], d["sal1"], d["sal2"]],
           [d["pairs"], d["pair_valid"], d["rgb"], *extra])


def test_total_loss_guards_non_finite(data):
    """A NaN saliency map: every saliency term falls back (0), the desc term
    stays finite; values equal, gradients NaN or not in the same places."""
    d = data
    sal1 = d["sal1"].copy()
    sal1[0, 0, 0, 0] = np.nan
    jb = jl.total_loss(*map(jnp.asarray, (d["desc1"], d["desc2"], d["pairs"], d["pair_valid"], sal1, d["sal2"],
                                          d["rgb"])))
    tb = tl.total_loss(*map(torch.from_numpy, (d["desc1"], d["desc2"], d["pairs"], d["pair_valid"], sal1, d["sal2"],
                                               d["rgb"])))
    assert set(jb.components) == set(tb.components)
    for k in jb.components:
        np.testing.assert_allclose(float(tb.components[k]), float(jb.components[k]), rtol=RTOL)
    assert float(jb.components["repeat"]) == float(tb.components["repeat"]) == 0.0
    np.testing.assert_allclose(float(tb.total), float(jb.total), rtol=RTOL)

    def jtotal(s):
        return jl.total_loss(*map(jnp.asarray, (d["desc1"], d["desc2"], d["pairs"], d["pair_valid"])), s,
                             jnp.asarray(d["sal2"]), jnp.asarray(d["rgb"])).total
    jg = np.asarray(jax.grad(jtotal)(jnp.asarray(sal1)))
    ts = torch.tensor(sal1, requires_grad=True)
    tl.total_loss(*map(torch.from_numpy, (d["desc1"], d["desc2"], d["pairs"], d["pair_valid"])), ts,
                  torch.from_numpy(d["sal2"]), torch.from_numpy(d["rgb"])).total.backward()
    np.testing.assert_array_equal(np.isnan(ts.grad.numpy()), np.isnan(jg))


def test_uncertainty_losses():
    rng = np.random.default_rng(3)
    conf = rng.uniform(0.05, 0.95, size=(2, 30, 1)).astype(np.float32)
    err = rng.uniform(0, 2, size=(2, 30)).astype(np.float32)
    valid = rng.random((2, 30)) < 0.7
    for jf, tf in ((junc.calibration_loss, tunc.calibration_loss), (junc.expected_error_loss, tunc.expected_error_loss)):
        _check(jf, tf, [conf, err], [valid])
        _check(jf, tf, [conf, err])


def test_calibration_loss_splits_tied_max_error():
    """Two keypoints share the largest error: the normaliser's gradient
    splits between them as jnp.max's does (torch.amax)."""
    conf = np.array([[[0.3], [0.6], [0.9], [0.5]]], np.float32)
    err = np.array([[0.4, 1.5, 1.5, 0.2]], np.float32)
    _check(junc.calibration_loss, tunc.calibration_loss, [conf, err])


def test_segmentation_loss():
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(2, 12, 16, 6))).astype(np.float32)
    labels = rng.integers(0, 6, size=(2, 12, 16)).astype(np.int32)
    valid = rng.random((2, 12, 16)) < 0.5
    _check(jseg.segmentation_loss, tseg.segmentation_loss, [logits], [labels])
    _check(jseg.segmentation_loss, tseg.segmentation_loss, [logits], [labels, valid])


def test_matches_to_pairs_exact():
    rng = np.random.default_rng(5)
    d1, d2 = _unit(rng.normal(size=(3, 40, 8))), _unit(rng.normal(size=(3, 50, 8)))
    v1, v2 = rng.random((3, 40)) < 0.8, rng.random((3, 50)) < 0.8
    jm = jmatching.match_cosine(*map(jnp.asarray, (d1, d2, v1, v2)), ratio=None)
    tm = tmatching.match_cosine(*map(torch.from_numpy, (d1, d2, v1, v2)), ratio=None)
    for k in (7, 40):
        jp, jv = jmatching.matches_to_pairs(jm, k)
        tp, tv = tmatching.matches_to_pairs(tm, k)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_mutual_score_gradient_splits_tied_maxima():
    """Row 0 of the similarity matrix holds its maximum in two columns.
    ``Matches.score`` carries gradient in training (the calibration terms);
    jnp.max gives each tied column half, as torch.amax does (the port's
    earlier ``max(dim).values`` gave one column all of it)."""
    sim = np.array([[[0.9, 0.2, 0.9, 0.1], [0.3, 0.8, 0.1, 0.2], [0.1, 0.4, 0.2, 0.7]]], np.float32)

    def jscore(s):
        return jnp.sum(jmatching._mutual_and_ratio(s, None, None, 0.95, None).score * jnp.arange(1.0, 4.0))

    jg = np.asarray(jax.grad(jscore)(jnp.asarray(sim)))
    ts = torch.tensor(sim, requires_grad=True)
    (tmatching._mutual_and_ratio(ts, None, None, 0.95, None).score * torch.arange(1.0, 4.0)).sum().backward()
    assert jg[0, 0, 0] == jg[0, 0, 2] == 0.5
    np.testing.assert_array_equal(ts.grad.numpy(), jg)
