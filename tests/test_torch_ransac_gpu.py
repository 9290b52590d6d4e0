"""The RANSAC kernel (``csrc/ransac.cu``) against its plain version
(``ops/kernels/ransac.py::ransac_plain``) on the card, and the SLAM loop
with it. Imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_ransac_gpu.py

Tolerances: the kernel rounds every operation and every sum as the plain
version's PyTorch calls do on the card, so at the SLAM paths' 500 and 512
correspondences with 64 hypotheses it gives their bits in every output.
Elsewhere it is held to rounding: the fits to the bit (they do not depend
on N), the supports within 1e-4 relative, the best hypothesis the plain
one or one whose support is within that of it, and then the mask and
weights of the hypothesis it took. Every test skips where
``torch.cuda.is_available()`` is False."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.core import camera, lie
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.ops.kernels import ransac as kransac
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


def _problem(seed, n, h=64, outliers=0.3):
    """The arguments of ``ransac`` before ``cam``: uniforms, world points,
    noisy camera-frame measurements and pixels under a known pose with gross
    outliers; then valid and fractional weights."""
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
    u = rng.random((h, 3)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (u, pw, pc_meas, obs, valid, weights)]


def _args(problem, weighted):
    u, pw, pc, obs, valid, w = problem
    return (u, pw, pc, obs, CAM, valid, w if weighted else None)


def _differ(got, ref):
    return [name for name, a, b in zip(kransac.Hypotheses._fields, got, ref)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]


def _compare(args, exact, **kw):
    """Kernel against plain on the same inputs: the same bits (``exact``),
    or agreement to rounding."""
    before = kransac.ransac.launches
    got = kransac.ransac(*args, **kw)
    ref = kransac.ransac_plain(*args, **kw)
    torch.cuda.synchronize()
    assert kransac.ransac.launches == before + 1
    differ = _differ(got, ref)
    if exact:
        bad = [h for h in range(got.Ts.shape[0]) if not torch.equal(got.Ts[h], ref.Ts[h])]
        assert not differ, (differ, "Ts rows", bad[:8], "supports", (got.supports - ref.supports).abs().max().item())
        return got, ref
    assert torch.equal(got.Ts, ref.Ts) and torch.equal(got.inls, ref.inls) and torch.equal(got.w_sem, ref.w_sem)
    torch.testing.assert_close(got.supports, ref.supports, rtol=1e-4, atol=0)
    b, rb = int(got.best), int(ref.best)
    if b != rb:
        assert abs(float(ref.supports[b]) - float(ref.supports[rb])) <= 1e-4 * abs(float(ref.supports[rb]))
    assert torch.equal(got.T_best, got.Ts[b])
    _, mask = pnp.count_inliers(got.Ts[b], args[1], args[3], CAM, args[5], kw.get("threshold", THRESHOLD))
    assert torch.equal(got.mask, mask)
    w = mask.float() if args[6] is None else mask.float() * args[6]
    assert torch.equal(got.w, w)
    return got, ref


@pytest.mark.parametrize("n", [500, 512])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_gives_the_plain_bits_at_the_paths_sizes(cuda, n, seed, weighted):
    """The SLAM paths' 512 (ORB) and 500 (learned) correspondences and 64
    hypotheses, weighted and not, over several draws: every output is the
    plain version's bits."""
    _compare(_args(_problem(100 + seed, n), weighted), exact=True)


@pytest.mark.parametrize("n", [3, 37, 127, 128, 130, 1001, 3000])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_agrees_to_rounding_at_other_sizes(cuda, n, weighted):
    got, ref = _compare(_args(_problem(300 + n, n), weighted), exact=False)
    print(f"N={n} weighted={weighted}: bit-equal outputs {not _differ(got, ref)}")


def test_loop_closing_shape(cuda):
    """The verification RANSAC of loop closing: 128 hypotheses, no weights."""
    got, ref = _compare(_args(_problem(7, 400, h=128), False), exact=False)
    print(f"H=128 N=400: bit-equal outputs {not _differ(got, ref)}")


def test_tied_supports_take_the_first_index(cuda):
    """Each draw twice (rows h and h + 32 of u equal), so every support
    ties with another: the kernel takes the first index of the largest, as
    torch.argmax does."""
    u, pw, pc, obs, valid, w = _problem(11, 512)
    u = torch.cat([u[:32], u[:32]])
    got, ref = _compare((u, pw, pc, obs, CAM, valid, w), exact=True)
    top = got.supports.max()
    assert int(got.best) == int(torch.nonzero(got.supports == top)[0, 0]) < 32


def test_every_point_invalid(cuda):
    u, pw, pc, obs, valid, w = _problem(5, 512)
    got, _ = _compare((u, pw, pc, obs, CAM, torch.zeros_like(valid), w), exact=True)
    assert int(got.best) == 0 and not bool(got.mask.any()) and not bool(got.inls.any())
    assert not bool(got.supports.any()) and not bool(got.w.any())


def test_each_call_is_one_launch_and_one_count(cuda, recording):
    args = _args(_problem(3, 512), True)
    before = kransac.ransac.launches
    with profiling.span("test.ransac"):
        kransac.ransac(*args)
        assert kransac.ransac.launches == before + 1
        kransac.ransac(*args)
    assert kransac.ransac.launches == before + 2
    assert _last("test.ransac")["counters"]["ransac_kernels"] == 2


def test_the_span_is_at_most_eight_launches(cuda):
    """The draw's weights and cumulative sum, then the kernel: at most eight
    kernels on the card, weighted or not (the profiler's device trace)."""
    from torch.profiler import ProfilerActivity, profile

    for weighted in (False, True):
        args = _args(_problem(4, 512), weighted)
        kransac.ransac(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kransac.ransac(*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        print(f"weighted={weighted}: {len(kernels)} kernels {kernels}")
        assert 1 <= len(kernels) <= 8, kernels


def test_ransac_pose_reads_nothing_on_the_host(cuda, recording):
    """``slam.ransac`` and ``slam.refine`` on the card: one kernel each and
    no host sync (on the CPU the plain version reads ``best`` and
    ``make_pose`` copies its row)."""
    u, pw, pc, obs, valid, w = _problem(4, 512)
    with profiling.span("test.ransac_pose"):
        res = pnp.ransac_pose(u, pw, pc, obs, CAM, valid, weights=w)
    c = _last("test.ransac_pose")
    assert c["counters"].get(profiling.HOST_SYNCS, 0) == 0, c
    assert not [k for k in c["spans"] if k.startswith("sync.")]
    assert c["counters"]["ransac_kernels"] == c["counters"]["refine_kernels"] == 1
    assert res.pose.is_cuda and int(res.num_inliers) == int(res.inlier_mask.sum())


# --- the SLAM loop -------------------------------------------------------------

def _orbit(cuda, weight_map=False):
    F = 60
    seq = synthetic.make_sequence(num_frames=F, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    kw = {}
    if weight_map:
        classes = torch.tensor([1.0, 0.7, 0.45, 0.3])
        rng = torch.Generator().manual_seed(11)
        kw["weight_map"] = classes[torch.randint(0, 4, (F, 15, 20), generator=rng)].numpy()
    feats = run_slam_cli.features_for_frames(gray, depth, 512, cuda, **kw)
    u = torch.rand((F, system.SlamConfig().num_hypotheses, 3), generator=torch.Generator().manual_seed(7)).to(cuda)
    return seq, feats, u


@pytest.mark.parametrize("weight_map", [False, True])
def test_run_slam_with_the_kernel_follows_the_plain_run(cuda, monkeypatch, weight_map):
    """A 60-frame synthetic orbit through ``run_slam`` on the card, the
    RANSAC span as the kernel and as the plain version, with unit and with
    fractional semantic weights: the same bits in every output."""
    seq, feats, u = _orbit(cuda, weight_map)
    F = u.shape[0]
    before = kransac.ransac.launches
    got = system.run_slam(u, feats, seq.cam)
    assert kransac.ransac.launches == before + F - 1
    monkeypatch.setattr(kransac, "ransac", kransac.ransac_plain)
    ref = system.run_slam(u, feats, seq.cam)
    gap = torch.linalg.norm(got.poses_wc[:, :3, 3].double() - ref.poses_wc[:, :3, 3].double(), dim=-1)
    assert float(gap.max()) == 0.0, float(gap.max())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
