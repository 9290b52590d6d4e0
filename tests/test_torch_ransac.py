"""The RANSAC wrapper (``ops/kernels/ransac.py``) on the CPU: CPU tensors
take the plain version and launch nothing, ``_check`` refuses what the
kernel does not take, and ``pnp.ransac_pose`` gives the bits it gave before
its RANSAC span became ``ransac`` (its parity against JAX is
``tests/test_torch_pnp.py``'s). The kernel itself runs in
``tests/test_torch_ransac_gpu.py``, on the card."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.core import camera, lie
from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
from semantic_slam_master_tpu_torch.ops.kernels import ransac as kransac
from semantic_slam_master_tpu_torch.slam import pnp
from semantic_slam_master_tpu_torch.utils import profiling

CAM = camera.TUM_FR2.scaled(0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=200, h=64, outliers=0.3):
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
    u = rng.random((h, 3)).astype(np.float32)
    return [torch.from_numpy(x) for x in (u, pw, pc_meas, obs, valid, weights)]


def _span_before(u, points, points_dst, observations, cam, valid, weights=None, inlier_threshold=3.0):
    """``pnp.ransac_pose``'s RANSAC span as it was before it became
    ``ransac``, without the recorder: (Ts, T_best, w_sem, supports, inls,
    best, mask, w)."""
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
    return Ts, T_best, w_sem, supports, inls, best, mask, w


def _ransac_pose_before(u, points, points_dst, observations, cam, valid, weights=None, inlier_threshold=3.0,
                        refine_iters=10):
    """``pnp.ransac_pose`` as it was before its RANSAC span became
    ``ransac``, without the recorder."""
    _, T_best, w_sem, supports, inls, best, mask, w = _span_before(
        u, points, points_dst, observations, cam, valid, weights, inlier_threshold)
    return kref.pnp_refine_plain(T_best, points, observations, cam, w, w_sem, valid, mask, supports, inls, best,
                                 inlier_threshold, refine_iters)


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_ransac_pose_on_the_cpu_gives_the_bits_it_gave_before(seed, weighted):
    u, pw, pc, obs, valid, w = _problem(seed, n=120 + 40 * seed)
    weights = w if weighted else None
    _assert_same(pnp.ransac_pose(u, pw, pc, obs, CAM, valid, weights=weights),
                 _ransac_pose_before(u, pw, pc, obs, CAM, valid, weights=weights))


@pytest.mark.parametrize("n", [3, 37, 500, 512])
@pytest.mark.parametrize("weighted", [False, True])
def test_ransac_on_the_cpu_is_the_span_it_replaced(n, weighted):
    """Every output of the plain version, bit for bit, at the SLAM paths'
    sizes and at odd ones."""
    u, pw, pc, obs, valid, w = _problem(10 + n, n=n)
    weights = w if weighted else None
    got = kransac.ransac(u, pw, pc, obs, CAM, valid, weights)
    assert isinstance(got, kransac.Hypotheses)
    _assert_same(got, _span_before(u, pw, pc, obs, CAM, valid, weights))


def test_the_loop_closing_call_takes_the_same_span():
    """128 hypotheses and no weights, as ``slam/loop_closing.py`` calls it."""
    u, pw, pc, obs, valid, _ = _problem(21, n=300, h=128)
    got = kransac.ransac(u, pw, pc, obs, CAM, valid)
    _assert_same(got, _span_before(u, pw, pc, obs, CAM, valid))
    assert got.Ts.shape == (128, 4, 4) and got.supports.shape == got.inls.shape == (128,)


def test_hypotheses_follow_from_each_other():
    u, pw, pc, obs, valid, w = _problem(4, n=300)
    got = kransac.ransac(u, pw, pc, obs, CAM, valid, w)
    b = int(got.best)
    assert b == int(torch.argmax(got.supports)) and torch.equal(got.T_best, got.Ts[b])
    assert int(got.inls[b]) == int(got.mask.sum())
    assert torch.equal(got.w, got.mask.float() * w)
    assert torch.equal(got.w_sem, valid.float() * w)
    assert float(got.supports[b]) == float(torch.sum(got.mask * got.w_sem))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    u, pw, pc, obs, valid, w = _problem(0)
    before = kransac.ransac.launches
    was = profiling.enabled
    profiling.enabled = True
    try:
        with profiling.span("test.ransac_cpu"):
            got = kransac.ransac(u, pw, pc, obs, CAM, valid, w)
    finally:
        profiling.enabled = was
    assert kransac.ransac.launches == before
    call = next(c for c in reversed(profiling.calls()) if c["name"] == "test.ransac_cpu")
    assert "ransac_kernels" not in call["counters"]
    # The plain version reads best on the host; kabsch's make_pose copies its row.
    assert call["spans"]["sync.ransac.best_pose"]["count"] == call["spans"]["sync.lie.make_pose"]["count"] == 1
    _assert_same(got, kransac.ransac_plain(u, pw, pc, obs, CAM, valid, w))


def _inputs(seed=0, n=150, h=64):
    """The arguments ``_check`` takes: u, points, points_dst, observations,
    valid, weights."""
    u, pw, pc, obs, valid, w = _problem(seed, n, h)
    return [u, pw, pc, obs, valid, w]


# (argument index, what replaces it): each the kernel would read wrongly.
BAD = {
    "u_f64": (0, lambda a: a[0].double()),
    "u_four_wide": (0, lambda a: torch.rand((a[0].shape[0], 4))),
    "u_1d": (0, lambda a: a[0].reshape(-1)),
    "points_f64": (1, lambda a: a[1].double()),
    "points_not_xyz": (1, lambda a: a[1][:, :2].contiguous()),
    "points_dst_short": (2, lambda a: a[2][:-1]),
    "points_dst_f16": (2, lambda a: a[2].half()),
    "observations_wide": (3, lambda a: torch.zeros((a[1].shape[0], 3))),
    "observations_short": (3, lambda a: a[3][:-1]),
    "valid_as_float": (4, lambda a: a[4].float()),
    "valid_long": (4, lambda a: torch.cat([a[4], a[4][:1]])),
    "weights_short": (5, lambda a: a[5][:-1]),
    "weights_f64": (5, lambda a: a[5].double()),
    "weights_2d": (5, lambda a: a[5][:, None]),
    "u_on_meta": (0, lambda a: a[0].to("meta")),
    "valid_on_meta": (4, lambda a: a[4].to("meta")),
    "weights_on_meta": (5, lambda a: a[5].to("meta")),
    "no_hypotheses": (0, lambda a: a[0][:0]),
    "no_points": (1, lambda a: a[1][:0]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_check_refuses_what_the_kernel_does_not_take(case):
    args = _inputs()
    i, bad = BAD[case]
    args[i] = bad(args)
    if case == "no_points":  # every per-point input empty together
        args[2], args[3], args[4], args[5] = args[2][:0], args[3][:0], args[4][:0], args[5][:0]
    with pytest.raises(ValueError):
        kransac._check(*args)


@pytest.mark.parametrize("weighted", [False, True])
def test_check_takes_the_span_inputs(weighted):
    args = _inputs()
    if not weighted:
        args[5] = None
    kransac._check(*args)


def test_a_device_other_than_the_card_is_refused():
    u, pw, pc, obs, valid, w = [x.to("meta") for x in _inputs()]
    with pytest.raises(ValueError, match="unsupported device"):
        kransac.ransac(u, pw, pc, obs, CAM, valid, w)
