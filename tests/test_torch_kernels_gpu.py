"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Every test skips where ``torch.cuda.is_available()`` is False."""

import pytest
import torch

from semantic_slam_master_tpu_torch.ops.kernels import fast_score as kfast
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


def test_wrappers_count_launches(cuda):
    before = (kfast.fast_score.launches, kpatch.gather_aligned_patches.launches)
    img = torch.rand((1, 64, 64), device=cuda)
    kfast.fast_score(img)
    kpatch.gather_aligned_patches(img, torch.full((1, 3, 2), 30.0, device=cuda))
    kfast.fast_score_plain(img)
    assert (kfast.fast_score.launches, kpatch.gather_aligned_patches.launches) == (
        before[0] + 1, before[1] + 1,
    )


def test_cpu_tensors_take_the_plain_version():
    before = kfast.fast_score.launches
    img = torch.rand((1, 40, 40))
    assert torch.equal(kfast.fast_score(img), kfast.fast_score_plain(img))
    assert kfast.fast_score.launches == before
