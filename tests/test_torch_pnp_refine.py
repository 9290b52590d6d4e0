"""The Gauss-Newton refinement wrapper (``ops/kernels/pnp_refine.py``) on
the CPU: CPU tensors take the plain version and launch nothing,
``_check`` refuses what the kernel does not take, and ``pnp.ransac_pose``
gives the bits it gave before the span became a kernel (its parity
against JAX is ``tests/test_torch_pnp.py``'s). The kernel itself runs in
``tests/test_torch_pnp_gpu.py``, on the card."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.core import camera, lie
from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
from semantic_slam_master_tpu_torch.slam import pnp
from semantic_slam_master_tpu_torch.utils import profiling

CAM = camera.TUM_FR2.scaled(0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=200, outliers=0.3):
    rng = np.random.default_rng(seed)
    T = lie.se3_exp(torch.from_numpy(rng.normal(0, [0.1, 0.1, 0.1, 0.05, 0.05, 0.05]).astype(np.float32)))
    pc = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(1.5, 4.0, n)], -1
    ).astype(np.float32)
    Tinv = np.linalg.inv(T.numpy().astype(np.float64))
    pw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    obs = camera.project(torch.from_numpy(pc), CAM).numpy() + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    bad = rng.random(n) < outliers
    obs[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    pc_meas = (pc * (1 + rng.normal(0, 0.005, (n, 1)))).astype(np.float32)
    valid = rng.random(n) < 0.95
    weights = rng.uniform(0.3, 1.0, n).astype(np.float32)
    u = rng.random((64, 3)).astype(np.float32)
    return [torch.from_numpy(x) for x in (u, pw, pc_meas, obs, valid, weights)]


def _ransac_pose_before(u, points, points_dst, observations, cam, valid, weights=None, inlier_threshold=3.0,
                        refine_iters=10):
    """``pnp.ransac_pose`` as it was before its refinement span became
    ``pnp_refine``, without the recorder."""
    w_sem = valid.to(points.dtype) if weights is None else valid.to(points.dtype) * weights
    probs = w_sem + 1e-6
    probs = probs / probs.sum()
    idx = pnp.sample_indices(probs, u)
    Ts = pnp.kabsch(points[idx], points_dst[idx])
    inls, masks = pnp.count_inliers(Ts, points, observations, cam, valid, inlier_threshold)
    supports = torch.sum(masks * w_sem, dim=-1)
    best = torch.argmax(supports)
    T_best = Ts[best]
    _, mask = pnp.count_inliers(T_best, points, observations, cam, valid, inlier_threshold)
    w = mask.to(points.dtype)
    if weights is not None:
        w = w * weights
    T_ref = pnp.refine_pose(T_best, points, observations, cam, weights=w, num_iters=refine_iters)
    inl_ref, mask_ref = pnp.count_inliers(T_ref, points, observations, cam, valid, inlier_threshold)
    sup_ref = torch.sum(mask_ref * w_sem)
    use_ref = sup_ref >= supports[best]
    T_final = torch.where(use_ref, T_ref, T_best)
    inl_final = torch.where(use_ref, inl_ref, inls[best])
    mask_final = torch.where(use_ref, mask_ref, mask)
    r, _ = pnp.reprojection_residuals(T_final, points, observations, cam)
    err2 = torch.sum(r * r, dim=-1)
    rmse = torch.sqrt(torch.sum(err2 * mask_final) / torch.clamp(torch.sum(mask_final), min=1))
    return T_final, inl_final, mask_final, rmse


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_ransac_pose_on_the_cpu_gives_the_bits_it_gave_before(seed, weighted):
    u, pw, pc, obs, valid, w = _problem(seed, n=120 + 40 * seed)
    weights = w if weighted else None
    got = pnp.ransac_pose(u, pw, pc, obs, CAM, valid, weights=weights)
    want = _ransac_pose_before(u, pw, pc, obs, CAM, valid, weights=weights)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _span_inputs(seed=0, n=150):
    """The positional arguments of ``pnp_refine`` from one RANSAC draw."""
    u, pw, pc, obs, valid, weights = _problem(seed, n)
    w_sem = valid.float() * weights
    probs = (w_sem + 1e-6) / (w_sem + 1e-6).sum()
    idx = pnp.sample_indices(probs, u)
    Ts = pnp.kabsch(pw[idx], pc[idx])
    inls, masks = pnp.count_inliers(Ts, pw, obs, CAM, valid)
    supports = torch.sum(masks * w_sem, dim=-1)
    best = torch.argmax(supports)
    _, mask = pnp.count_inliers(Ts[best], pw, obs, CAM, valid)
    return [Ts[best], pw, obs, CAM, mask.float() * weights, w_sem, valid, mask, supports, inls, best]


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    args = _span_inputs()
    before = kref.pnp_refine.launches
    was = profiling.enabled
    profiling.enabled = True
    try:
        with profiling.span("test.refine_cpu"):
            got = kref.pnp_refine(*args)
    finally:
        profiling.enabled = was
    want = kref.pnp_refine_plain(*args)
    assert kref.pnp_refine.launches == before
    call = next(c for c in reversed(profiling.calls()) if c["name"] == "test.refine_cpu")
    assert "refine_kernels" not in call["counters"]
    # The plain version reads supports[best] and inls[best] on the host.
    assert call["spans"]["sync.refine.best_support"]["count"] == call["spans"]["sync.refine.best_inliers"]["count"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _replace(args, i, x):
    return args[:i] + [x] + args[i + 1:]


# (argument index, what replaces it): each the kernel would read wrongly.
BAD = {
    "points_f64": (1, lambda a: a[1].double()),
    "points_not_xyz": (1, lambda a: a[1][:, :2].contiguous()),
    "observations_wide": (2, lambda a: torch.zeros((a[1].shape[0], 3))),
    "T_best_3x4": (0, lambda a: a[0][:3]),
    "w_short": (4, lambda a: a[4][:-1]),
    "w_sem_long": (5, lambda a: torch.cat([a[5], a[5][:1]])),
    "valid_as_float": (6, lambda a: a[6].float()),
    "mask_short": (7, lambda a: a[7][:-1]),
    "inls_int32": (9, lambda a: a[9].int()),
    "inls_short": (9, lambda a: a[9][:-1]),
    "supports_2d": (8, lambda a: a[8][None]),
    "best_1d": (10, lambda a: a[10][None]),
    "w_on_meta": (4, lambda a: a[4].to("meta")),
    "supports_on_meta": (8, lambda a: a[8].to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_check_refuses_what_the_kernel_does_not_take(case):
    args = _span_inputs()
    i, bad = BAD[case]
    args = _replace(args, i, bad(args))
    with pytest.raises(ValueError):
        kref._check(*args[:3], *args[4:])


def test_check_takes_the_span_inputs_and_refuses_no_hypotheses():
    args = _span_inputs()
    kref._check(*args[:3], *args[4:])
    args[8], args[9] = args[8][:0], args[9][:0]
    with pytest.raises(ValueError):
        kref._check(*args[:3], *args[4:])


def test_a_device_other_than_the_card_is_refused():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in _span_inputs()]
    with pytest.raises(ValueError, match="unsupported device"):
        kref.pnp_refine(*args)
