"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Every test skips where ``torch.cuda.is_available()`` is False."""

import pytest
import torch

from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Shapes on and off the kernel's 128 x 16 tile: exact multiples, ragged
# heights and widths, widths no multiple of 4 (no 16-byte rows), B = 1.
FAST_SHAPES = [(2, 480, 640), (2, 83, 300), (1, 7, 5), (1, 64, 128), (1, 37, 129), (3, 33, 257), (1, 1, 1)]


@pytest.mark.parametrize("shape", FAST_SHAPES)
def test_fast_score_kernel_matches_plain(cuda, shape):
    img = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    got = kfast.fast_score(img, 0.05)
    ref = kfast.fast_score_plain(img, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, ref > 0)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(2, 480, 640), (1, 37, 129), (3, 83, 300)])
def test_fast_score_smooth_and_noise_match_plain(cuda, shape):
    """Bit-exact on smooth texture, where few pixels pass the 4-point test
    and whole warps skip the 16-point chain, and on noise, where most do."""
    gen = torch.Generator().manual_seed(4)
    B, H, W = shape
    smooth = torch.nn.functional.interpolate(torch.rand((B, 1, H // 8 + 1, W // 8 + 1), generator=gen),
                                             size=(H, W), mode="bilinear")[:, 0].contiguous()
    for img in (smooth.to(cuda), torch.rand(shape, generator=gen).to(cuda)):
        assert torch.equal(kfast.fast_score(img, 0.05), kfast.fast_score_plain(img, 0.05))


@pytest.mark.parametrize("shape,n", [((2, 480, 640), 202), ((1, 59, 300), 37), ((3, 32, 33), 5),
                                     ((1, 32, 33), 1), ((1, 480, 640), 1), ((16, 280, 384), 70)])
def test_patch_kernel_matches_plain(cuda, shape, n):
    B, H, W = shape
    gen = torch.Generator().manual_seed(1)
    img = (torch.rand(shape, generator=gen) * 1.2 - 0.1).to(cuda)
    xy = torch.rand((B, n, 2), generator=gen) * torch.tensor([W + 10.0, H + 10.0]) - 5.0
    xy[:, 0] = torch.tensor([W - 17.5, H - 16.5])  # half-pixel tie at the clamp edge
    got = kpatch.gather_aligned_patches(img, xy.to(cuda))
    ref = kpatch.gather_aligned_patches_plain(img, xy.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, n, 32, 32)
    assert torch.equal(got, ref)


def _centers(B, n, H, W, gen):
    xy = torch.rand((B, n, 2), generator=gen) * torch.tensor([W + 40.0, H + 40.0]) - 20.0
    xy[:, 0] = torch.tensor([10.5, 2.5])  # half-pixel ties
    xy[:, -1] = torch.tensor([W - 0.5, H + 3.0])  # beyond the clamp edge
    return xy


# B N = 111 is a multiple neither of the kernel's 8 keypoints per block nor
# of 4 (a ragged last block, windows at odd float offsets); N = 1 is one
# warp; side 7 is a window smaller than a warp-wide load, sides 31 and
# 33 take two and three passes of 512 pixels.
@pytest.mark.parametrize("shape,n,radius", [((8, 480, 640), 500, 10), ((1, 59, 300), 37, 10), ((2, 21, 33), 5, 10),
                                            ((3, 40, 40), 9, 15), ((3, 83, 300), 37, 10), ((1, 480, 640), 1, 10),
                                            ((1, 64, 80), 9, 3), ((2, 70, 90), 11, 15), ((1, 70, 90), 5, 16)])
def test_gather_patches_kernel_matches_plain(cuda, shape, n, radius):
    B, H, W = shape
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(shape, generator=gen).to(cuda)
    xy = _centers(B, n, H, W, gen).to(cuda)
    got = kgather.gather_patches(img, xy, radius)
    ref = kgather.gather_patches_reference(img, xy, radius, 2 * radius + 1)
    torch.cuda.synchronize()
    assert got.shape == (B, n, 2 * radius + 1, 2 * radius + 1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,n", [((2, 64, 128), 16), ((1, 48, 128), 8), ((1, 64, 128), 7), ((2, 480, 640), 8192),
                                     ((3, 83, 300), 37), ((1, 480, 640), 1)])
def test_gather_patches_padded_kernel_matches_plain(cuda, shape, n):
    B, H, W = shape
    gen = torch.Generator().manual_seed(3)
    img = torch.randn(shape, generator=gen).to(cuda)
    xy = _centers(B, n, H, W, gen).to(cuda)
    got = kgather.gather_patches_padded(img, xy, 15)
    ref = kgather.gather_patches_reference(img, xy, 15, 32)
    torch.cuda.synchronize()
    assert got.shape == (B, n, 32, 32)
    assert torch.equal(got, ref)


EXTREMES = [float("inf"), float("-inf"), float("nan"), 3e9, -3e9]


@pytest.mark.parametrize("wrapper,radius,side", [("gather_patches", 10, 21), ("gather_patches_padded", 15, 32)])
def test_gather_patches_non_finite_centres_match_plain(cuda, wrapper, radius, side):
    """+-inf, NaN and +-3e9 in x, y or both land where the plain version
    (JAX's saturating conversion before the clip) puts them."""
    B, H, W = 2, 83, 300
    pts = [p for v in EXTREMES for p in ((v, H / 2), (W / 2, v), (v, v))]
    pts += [(u, v) for u in EXTREMES for v in EXTREMES if u is not v]
    gen = torch.Generator().manual_seed(5)
    img = torch.randn((B, H, W), generator=gen).to(cuda)
    xy = torch.tensor(pts, dtype=torch.float32)[None].repeat(B, 1, 1).to(cuda)
    got = getattr(kgather, wrapper)(img, xy, radius)
    ref = kgather.gather_patches_reference(img, xy, radius, side)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_wrappers_count_launches(cuda):
    counters = (kfast.fast_score, kpatch.gather_aligned_patches, kgather.gather_patches,
                kgather.gather_patches_padded)
    before = [c.launches for c in counters]
    img = torch.rand((1, 64, 64), device=cuda)
    xy = torch.full((1, 3, 2), 30.0, device=cuda)
    kfast.fast_score(img)
    kpatch.gather_aligned_patches(img, xy)
    kgather.gather_patches(img, xy, 10)
    kgather.gather_patches_padded(img, xy, 15)
    kfast.fast_score_plain(img)
    kgather.gather_patches_reference(img, xy, 10, 21)
    assert [c.launches for c in counters] == [b + 1 for b in before]


def test_suite_adapters_count_launches(cuda):
    """The acceptance suite's adapters on the card: one pyramid ORB extract
    launches each ORB kernel once per level (4), one single-scale ORB
    extract once each, and one learned extract with sub-patch refinement
    gathers once."""
    import numpy as np

    from semantic_slam_master_tpu_torch.eval import frontend_tests
    from semantic_slam_master_tpu_torch.models.frontend import tiny_frontend

    rgb = np.random.default_rng(0).uniform(size=(2, 240, 320, 3)).astype(np.float32)
    orb_counters = (kfast.fast_score, kpatch.gather_aligned_patches)
    for adapter, per_extract in ((frontend_tests.pyramid_orb_adapter(num_keypoints=200, device=cuda), 4),
                                 (frontend_tests.orb_adapter(num_keypoints=200, device=cuda), 1)):
        before = [c.launches for c in orb_counters]
        feats = adapter.extract(rgb)
        assert feats["xy"].shape == (2, 200, 2) and feats["valid"].any()
        assert [c.launches for c in orb_counters] == [b + per_extract for b in before]
    model = tiny_frontend(subpatch_refine=True, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    adapter = frontend_tests.learned_adapter(model.to(cuda).eval(), input_size=224)
    before = kgather.gather_patches.launches
    feats = adapter.extract(rgb)
    assert kgather.gather_patches.launches == before + 1
    assert feats["xy"].shape == (2, model.num_keypoints, 2)


def test_cpu_tensors_take_the_plain_version():
    before = kfast.fast_score.launches
    img = torch.rand((1, 40, 40))
    assert torch.equal(kfast.fast_score(img), kfast.fast_score_plain(img))
    assert kfast.fast_score.launches == before


def test_gather_patches_refuses_grad_on_card(cuda):
    """The kernel has no backward: an image that requires grad is refused,
    not silently cut from the graph."""
    img = torch.zeros((1, 64, 64), device=cuda, requires_grad=True)
    centres = torch.full((1, 3, 2), 32.0, device=cuda)
    before = kgather.gather_patches.launches
    with pytest.raises(ValueError, match="no backward"):
        kgather.gather_patches(img, centres, 10)
    assert kgather.gather_patches.launches == before


def test_orb_patch_paths_at_radius_15_match_cpu(cuda):
    """``orb.orientations`` and ``orb.describe_from_patches`` take the
    gather kernel at radius 15 (31x31 windows): at the ORB path's level-0
    shape, the windows equal the plain version's, one launch per call, and
    the orientations and descriptors equal the CPU's. The frame holds
    u8-grid intensities, as every ORB path quantises before its moments:
    the moment sums are then exact integers in any order, and the angles
    differ by atan2's last bits at most (on [0, 1) floats the 961-term sums
    round in cuBLAS's order, and a near-zero moment turns that into
    ~2e-4 rad)."""
    from semantic_slam_master_tpu_torch.ops import orb

    B, H, W, n = 4, 480, 640, 202
    gen = torch.Generator().manual_seed(6)
    img = kpatch.quantize_u8(torch.rand((B, H, W), generator=gen))
    xy = _centers(B, n, H, W, gen)
    img_c, xy_c = img.to(cuda), xy.to(cuda)
    assert torch.equal(kgather.gather_patches(img_c, xy_c, 15).cpu(), kgather.gather_patches_reference(img, xy, 15, 31))
    before = kgather.gather_patches.launches
    theta = orb.orientations(img_c, xy_c)
    patches = kgather.gather_patches(img_c / 255.0, xy_c, 15)
    desc = orb.describe_from_patches(patches)
    assert kgather.gather_patches.launches == before + 2
    torch.testing.assert_close(theta.cpu(), orb.orientations(img, xy), rtol=0, atol=1e-6)
    assert torch.equal(desc.cpu(), orb.describe_from_patches(kgather.gather_patches(img / 255.0, xy, 15)))


@pytest.mark.parametrize("shape", [(24, 32), (32, 32), (24, 64), (32, 64), (48, 80), (120, 100)])
def test_describe_on_small_levels_matches_cpu(cuda, shape):
    """``orb.describe`` on pyramid-floor frames on the card equals the CPU:
    the aligned kernel where the frame takes it (with the row padding for
    (24, 64)), the gather path elsewhere."""
    from semantic_slam_master_tpu_torch.ops import orb

    H, W = shape
    gen = torch.Generator().manual_seed(7)
    img = torch.rand((2, H, W), generator=gen)
    xy = torch.rand((2, 40, 2), generator=gen) * torch.tensor([W + 10.0, H + 10.0]) - 5.0
    before = kpatch.gather_aligned_patches.launches
    got = orb.describe(img.to(cuda), xy.to(cuda))
    aligned = (H >= 32 and W >= 33) or (W % 32 == 0 and W >= 64)
    assert kpatch.gather_aligned_patches.launches == before + int(aligned)
    assert torch.equal(got.cpu(), orb.describe(img, xy))
