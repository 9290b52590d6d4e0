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


@pytest.mark.parametrize("shape", [(2, 480, 640), (2, 83, 300), (1, 7, 5)])
def test_fast_score_kernel_matches_plain(cuda, shape):
    img = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    got = kfast.fast_score(img, 0.05)
    ref = kfast.fast_score_plain(img, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got > 0, ref > 0)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape,n", [((2, 480, 640), 202), ((1, 59, 300), 37), ((3, 32, 33), 5)])
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


@pytest.mark.parametrize("shape,n,radius", [((8, 480, 640), 500, 10), ((1, 59, 300), 37, 10), ((2, 21, 33), 5, 10), ((3, 40, 40), 9, 15)])
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


@pytest.mark.parametrize("shape,n", [((2, 64, 128), 16), ((1, 48, 128), 8), ((1, 64, 128), 7), ((2, 480, 640), 8192)])
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


def test_cpu_tensors_take_the_plain_version():
    before = kfast.fast_score.launches
    img = torch.rand((1, 40, 40))
    assert torch.equal(kfast.fast_score(img), kfast.fast_score_plain(img))
    assert kfast.fast_score.launches == before
