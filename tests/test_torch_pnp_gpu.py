"""The Gauss-Newton refinement kernel (``csrc/pnp_refine.cu``) against its
plain version (``ops/kernels/pnp_refine.py::pnp_refine_plain``) on the
card, and the SLAM loop's counters with it. Imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_pnp_gpu.py

Tolerances: the kernel rounds each Gauss-Newton step as the plain
version's PyTorch, cuBLAS and cuSOLVER calls do at the SLAM paths' 500
and 512 correspondences, so there it gives their bits; at other sizes
the library's GEMM splits its sums otherwise, and poses agree within 1e-5
elementwise, rmse within 1e-5 relative, and an inlier test may differ
only for a point within 1e-4 px of the threshold. Both keep the refined
pose when ``torch.sum(mask_ref * w_sem)`` is not below ``supports[best]``,
the kernel summing in ``torch.sum``'s order: at 500 and 512 the choice is
the plain version's; elsewhere it may differ only where the refined
poses' rounding moves a point across the threshold, and then the kernel
is held to the plain version's other choice. Below 3 correspondences the Gauss-Newton
system has rank 2 and only the damping (1e-4, against entries near 1e5)
fixes the other four directions, a condition beyond f32's precision: any
two f32 solvers differ there, so a single correspondence is checked for
consistency (a finite rigid pose, the count, mask and rmse that follow
from it), not against the plain version. Every test skips where
``torch.cuda.is_available()`` is False."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.core import camera, lie
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.ops.kernels import pnp_refine as kref
from semantic_slam_master_tpu_torch.slam import pnp, system
from semantic_slam_master_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

CAM = camera.TUM_FR2.scaled(0.5, 0.5)
THRESHOLD = 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def recording():
    was = profiling.enabled
    profiling.enabled = True
    yield
    profiling.enabled = was


def _last(name):
    return next(c for c in reversed(profiling.calls()) if c["name"] == name)


def _problem(seed, n, outliers=0.3):
    """``tests/test_torch_pnp.py``'s problem with the port's own Lie and
    camera functions: world points, noisy camera-frame measurements and
    pixels under a known pose, with gross outliers."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, [0.1, 0.1, 0.1, 0.05, 0.05, 0.05]).astype(np.float32)
    T = lie.se3_exp(torch.from_numpy(xi)).numpy()
    pc = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n), rng.uniform(1.5, 4.0, n)], -1
    ).astype(np.float32)
    Tinv = np.linalg.inv(T.astype(np.float64))
    pw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    obs = camera.project(torch.from_numpy(pc), CAM).numpy() + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    bad = rng.random(n) < outliers
    obs[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    pc_meas = (pc * (1 + rng.normal(0, 0.005, (n, 1)))).astype(np.float32)
    valid = rng.random(n) < 0.95
    weights = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (T, pw, pc_meas, obs, valid, weights)]


def _span_inputs(points, points_dst, obs, valid, weights, seed):
    """What ``pnp.ransac_pose``'s RANSAC span hands ``pnp_refine``: the
    positional arguments from ``T_best`` to ``best`` (a copy of its lines)."""
    dev = points.device
    u = torch.rand((64, 3), generator=torch.Generator().manual_seed(seed)).to(dev)
    w_sem = valid.float() if weights is None else valid.float() * weights
    probs = w_sem + 1e-6
    probs = probs / probs.sum()
    idx = pnp.sample_indices(probs, u)
    Ts = pnp.kabsch(points[idx], points_dst[idx])
    inls, masks = pnp.count_inliers(Ts, points, obs, CAM, valid, THRESHOLD)
    supports = torch.sum(masks * w_sem, dim=-1)
    best = torch.argmax(supports)
    T_best = Ts[best]
    _, mask = pnp.count_inliers(T_best, points, obs, CAM, valid, THRESHOLD)
    w = mask.float() if weights is None else mask.float() * weights
    return [T_best, points, obs, CAM, w, w_sem, valid, mask, supports, inls, best]


def _empty_inputs(dev):
    """N = 0: no correspondence, one hypothesis of support 0."""
    z = torch.zeros((0,), device=dev)
    T0 = torch.eye(4, device=dev)
    T0[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
    return [T0, torch.zeros((0, 3), device=dev), torch.zeros((0, 2), device=dev), CAM, z, z,
            torch.zeros((0,), dtype=torch.bool, device=dev), torch.zeros((0,), dtype=torch.bool, device=dev),
            torch.zeros((64,), device=dev), torch.zeros((64,), dtype=torch.int64, device=dev),
            torch.tensor(0, device=dev)]


def _consistent(args, got, threshold=THRESHOLD):
    """The kernel's outputs follow from its pose: a finite rigid pose,
    T_best with its mask and count when kept, else the pose's own inlier
    test; the count is the mask's; the rmse is the mask's."""
    T_best, points, obs, cam, _, _, valid, mask, _, inls, best = args
    pose, n, m, rmse = got
    assert pose.shape == (4, 4) and pose.dtype == torch.float32 and bool(torch.isfinite(pose).all())
    assert n.shape == () and n.dtype == torch.int64 and m.shape == mask.shape and m.dtype == torch.bool
    assert rmse.shape == () and rmse.dtype == torch.float32
    R = pose[:3, :3].double()
    torch.testing.assert_close(R @ R.T, torch.eye(3, dtype=torch.float64, device=R.device), atol=1e-5, rtol=0)
    assert torch.equal(pose[3], torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose.device))
    if torch.equal(pose, T_best):
        assert torch.equal(m, mask) or torch.equal(m, pnp.count_inliers(pose, points, obs, cam, valid, threshold)[1])
    else:
        r, _ = pnp.reprojection_residuals(pose, points, obs, cam)
        near = (torch.linalg.norm(r, dim=-1) - threshold).abs() < 1e-4
        _, own = pnp.count_inliers(pose, points, obs, cam, valid, threshold)
        assert torch.equal(m[~near], own[~near])
    assert int(n) == int(m.sum())
    r, _ = pnp.reprojection_residuals(pose, points, obs, cam)
    want = torch.sqrt(torch.sum(torch.sum(r * r, dim=-1) * m) / torch.clamp(torch.sum(m), min=1))
    torch.testing.assert_close(rmse, want, rtol=1e-5, atol=1e-6)


def _compare(args, exact=False, **kw):
    """Kernel against plain on the same inputs. Where the two choose
    differently between the refined pose and T_best (at sizes where their
    refined poses differ in rounding), the kernel is held to the plain
    version's other choice. ``exact``: the same choice and the same bits,
    not only close."""
    T_best, points, obs, cam, w, w_sem, valid, mask, supports, inls, best = args
    threshold = kw.get("threshold", THRESHOLD)
    before = kref.pnp_refine.launches
    got = kref.pnp_refine(*args, **kw)
    ref = list(kref.pnp_refine_plain(*args, **kw))
    torch.cuda.synchronize()
    assert kref.pnp_refine.launches == before + 1
    _consistent(args, got, threshold)
    gn = {k: v for k, v in kw.items() if k != "threshold"}
    T_ref = pnp.refine_pose(T_best, points, obs, cam, weights=w, **gn)
    inl_ref, mask_ref = pnp.count_inliers(T_ref, points, obs, cam, valid, threshold)
    sup_ref, sup_best = float(torch.sum(mask_ref * w_sem)), float(supports[best])
    kept, rkept = torch.equal(got[0], T_best), torch.equal(ref[0], T_best)
    assert not exact or kept == rkept
    if kept != rkept:
        assert abs(sup_ref - sup_best) <= 1e-5 * max(abs(sup_best), 1.0), (sup_ref, sup_best)
        ref[:3] = (T_best, inls[best], mask) if kept else (T_ref, inl_ref, mask_ref)
        r, _ = pnp.reprojection_residuals(ref[0], points, obs, cam)
        ref[3] = torch.sqrt(torch.sum(torch.sum(r * r, dim=-1) * ref[2]) / torch.clamp(torch.sum(ref[2]), min=1))
    pose, n, m, rmse = got
    rpose, rn, rm, rrmse = ref
    torch.testing.assert_close(pose, rpose, atol=1e-5, rtol=0)
    r, _ = pnp.reprojection_residuals(rpose, points, obs, cam)
    near = (torch.linalg.norm(r, dim=-1) - threshold).abs() < 1e-4
    assert torch.equal(m[~near], rm[~near])
    assert abs(int(n) - int(rn)) <= int(near.sum())
    torch.testing.assert_close(rmse, rrmse, rtol=1e-5, atol=0)
    if exact:
        assert torch.equal(pose, rpose) and torch.equal(m, rm) and int(n) == int(rn) and torch.equal(rmse, rrmse)
    return kept, rkept


@pytest.mark.parametrize("n", [0, 1, 7, 200, 500, 512, 2048])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_matches_plain(cuda, n, weighted):
    if n == 0:
        _compare(_empty_inputs(cuda), exact=True)
        return
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(n, n)]
    args = _span_inputs(pw, pc, obs, valid, w if weighted else None, seed=n)
    if n < 3:
        _consistent(args, kref.pnp_refine(*args))
    else:
        _compare(args, exact=n in (500, 512))


@pytest.mark.parametrize("n", [500, 512])
@pytest.mark.parametrize("seed", range(8))
def test_kernel_gives_the_plain_bits_at_the_paths_sizes(cuda, n, seed):
    """The SLAM paths' 512 (ORB) and 500 (learned) correspondences, weighted
    and not, over several RANSAC draws: the kernel's pose, count and mask
    are the plain version's bits, save where the two supports tie to
    rounding."""
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(100 + seed, n)]
    _compare(_span_inputs(pw, pc, obs, valid, w if seed % 2 else None, seed=seed), exact=True)


@pytest.mark.parametrize("n", [7, 100, 128, 200, 500, 512, 1000, 2048, 3001])
def test_the_choice_follows_the_plain_sums_bits(cuda, n):
    """Refine-or-keep compares ``torch.sum(mask_ref * w_sem)`` with
    ``supports[best]`` as the plain version does: with ``supports[best]``
    set to that sum, taken on the card from the kernel's own refined mask
    and fractional weights, the kernel keeps the refined pose; one step
    above it, T_best. So the kernel's sum has the same bits as
    ``torch.sum``'s at every size."""
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(200 + n, n)]
    args = _span_inputs(pw, pc, obs, valid, w, seed=n)
    supports, inls, best = args[8:]
    marked = inls.clone()
    marked[best] = -1  # the count of a kept T_best
    low = supports.clone()
    low[best] = -float("inf")
    _, count, mask_ref, _ = kref.pnp_refine(*args[:8], low, marked, best)
    assert int(count) == int(mask_ref.sum())
    s = torch.sum(mask_ref * args[5])
    for support, keeps in ((s, False), (torch.nextafter(s, torch.tensor(float("inf"), device=cuda)), True)):
        tie = supports.clone()
        tie[best] = support
        got = kref.pnp_refine(*args[:8], tie, marked, best)
        assert (int(got[1]) == -1) == keeps, (n, float(s), float(support))


def test_every_point_invalid(cuda):
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(5, 300)]
    args = _span_inputs(pw, pc, obs, torch.zeros_like(valid), w, seed=5)
    pose, n, m, rmse = kref.pnp_refine(*args)
    _compare(args)
    assert torch.equal(pose, args[0]) and int(n) == 0 and not bool(m.any()) and float(rmse) == 0.0


def test_a_singular_step_is_zeroed(cuda):
    """Points on the optical axis leave H's rows 2 and 5 zero; undamped,
    the 6x6 is singular, every step is not finite and is zeroed, so both
    versions return T_best itself."""
    rng = np.random.default_rng(0)
    n = 60
    pts = torch.zeros((n, 3))
    pts[:, 2] = torch.linspace(1.5, 4.0, n)
    obs = torch.tensor([CAM.cx, CAM.cy]) + torch.from_numpy(rng.normal(0, 1.0, (n, 2)).astype(np.float32))
    pts, obs = pts.to(cuda), obs.to(cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    T_best = torch.eye(4, device=cuda)
    inl, mask = pnp.count_inliers(T_best, pts, obs, CAM, valid, THRESHOLD)
    w_sem = valid.float()
    args = [T_best, pts, obs, CAM, mask.float(), w_sem, valid, mask, torch.sum(mask * w_sem)[None], inl[None],
            torch.tensor(0, device=cuda)]
    for got in (kref.pnp_refine(*args, damping=0.0), kref.pnp_refine_plain(*args, damping=0.0)):
        assert torch.equal(got[0], T_best) and torch.equal(got[2], mask)
    _compare(args, damping=0.0)
    # Damped, Gauss-Newton does move the pose on the same set.
    assert not torch.equal(pnp.refine_pose(T_best, pts, obs, CAM, weights=mask.float()), T_best)


def test_each_call_is_one_launch_and_one_count(cuda, recording):
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(3, 512)]
    args = _span_inputs(pw, pc, obs, valid, w, seed=3)
    before = kref.pnp_refine.launches
    with profiling.span("test.refine"):
        kref.pnp_refine(*args)
        assert kref.pnp_refine.launches == before + 1
        kref.pnp_refine(*args)
    assert kref.pnp_refine.launches == before + 2
    assert _last("test.refine")["counters"]["refine_kernels"] == 2


def test_ransac_pose_takes_the_kernel(cuda):
    _, pw, pc, obs, valid, w = [x.to(cuda) for x in _problem(4, 512)]
    u = torch.rand((64, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    before = kref.pnp_refine.launches
    res = pnp.ransac_pose(u, pw, pc, obs, CAM, valid, weights=w)
    assert kref.pnp_refine.launches == before + 1
    assert res.pose.is_cuda and int(res.num_inliers) == int(res.inlier_mask.sum())


# --- the SLAM loop -------------------------------------------------------------

def test_run_slam_with_the_kernel_follows_the_plain_run(cuda, monkeypatch):
    """A 60-frame synthetic orbit through ``run_slam`` on the card, the
    refinement as the kernel and as the plain version: positions within
    5e-6 m (orb_tum640's limit on the benchmark's pose gap), and in fact
    the same bits."""
    F = 60
    seq = synthetic.make_sequence(num_frames=F, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    feats = run_slam_cli.features_for_frames(gray, depth, 512, cuda)
    u = torch.rand((F, system.SlamConfig().num_hypotheses, 3), generator=torch.Generator().manual_seed(7)).to(cuda)
    before = kref.pnp_refine.launches
    got = system.run_slam(u, feats, seq.cam)
    assert kref.pnp_refine.launches == before + F - 1
    monkeypatch.setattr(kref, "pnp_refine", kref.pnp_refine_plain)
    ref = system.run_slam(u, feats, seq.cam)
    gap = torch.linalg.norm(got.poses_wc[:, :3, 3].double() - ref.poses_wc[:, :3, 3].double(), dim=-1)
    assert float(gap.max()) <= 5e-6, float(gap.max())
    assert torch.equal(got.is_keyframe, ref.is_keyframe)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_run_slam_with_fractional_weights_gives_the_plain_bits(cuda, monkeypatch):
    """As above with a semantic weight map of fractional class weights
    (the learned path's kind of weights), whose support sums round
    differently in different orders: the same bits, so every frame made
    the plain version's refine-or-keep choice."""
    F = 60
    seq = synthetic.make_sequence(num_frames=F, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    classes = torch.tensor([1.0, 0.7, 0.45, 0.3])
    rng = torch.Generator().manual_seed(11)
    weight_map = classes[torch.randint(0, 4, (F, 15, 20), generator=rng)]
    feats = run_slam_cli.features_for_frames(gray, depth, 512, cuda, weight_map=weight_map.numpy())
    assert bool(((feats.sem_weight != 1) & feats.valid).any())
    u = torch.rand((F, system.SlamConfig().num_hypotheses, 3), generator=torch.Generator().manual_seed(9)).to(cuda)
    got = system.run_slam(u, feats, seq.cam)
    monkeypatch.setattr(kref, "pnp_refine", kref.pnp_refine_plain)
    ref = system.run_slam(u, feats, seq.cam)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


F_COUNT = 10


@pytest.fixture(scope="module")
def orb_run_gpu():
    """``tests/test_torch_trace.py``'s ``orb_run``, its features on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seq = synthetic.make_sequence(num_frames=F_COUNT, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    cfg = system.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=2)
    feats = run_slam_cli.features_for_frames(gray, depth, 300, torch.device("cuda"))
    u = torch.rand((F_COUNT, cfg.num_hypotheses, 3), generator=torch.Generator().manual_seed(3)).cuda()
    return seq, feats, u, cfg


def test_slam_counters_follow_the_output_on_the_card(orb_run_gpu, recording):
    """``tests/test_torch_trace.py::test_slam_counters_follow_the_output``
    on the card: ``slam.refine`` is one kernel a tracked frame, so its 10
    Gauss-Newton poses' constant rows and its two reads of ``best`` are
    gone, 12 host syncs a tracked frame; ``slam.ransac`` is one kernel a
    tracked frame too (``ops/kernels/ransac.py``), so its read of ``best``
    and ``kabsch``'s constant row are gone, 2 more."""
    seq, feats, u, cfg = orb_run_gpu
    out = system.run_slam(u, feats, seq.cam, cfg)
    c = _last("slam.run")
    kf = int(out.is_keyframe[1:].sum())
    assert kf >= 1
    tracked, updates = F_COUNT - 1, 1 + kf
    assert c["counters"]["keyframes"] == kf
    assert c["counters"]["refine_kernels"] == c["counters"]["ransac_kernels"] == tracked
    assert c["counters"][profiling.HOST_SYNCS] == (17 - 12 - 2) * tracked + 22 * updates + (1 + cfg.ba_iters) * kf + 1
    s = c["spans"]
    assert s["sync.lie.make_pose"]["count"] == 2 * tracked + cfg.ba_iters * kf
    assert not [k for k in s if k.startswith(("sync.refine.", "sync.ransac."))]
    for name in ("slam.match", "slam.ransac", "slam.refine", "sync.step.need_kf"):
        assert s[name]["count"] == tracked, name
