"""Aligned 32x32 keypoint patch gather: CUDA kernel wrapper and its plain
version.

Counterpart of the TPU kernel ``ops/pallas/patches.py::
gather_aligned_patches`` as ``describe_matmul`` calls it there: from the
f32 (blurred) frame it gathers, for every keypoint, the 32x32 patch with
the keypoint at (15, 15), quantised to the u8 grid and stored as bf16.
The kernel is ``csrc/aligned_patches.cu``; both versions give the same
bits.
"""

from __future__ import annotations

import torch

from ...core.fixed import round_clip_xy

PATCH = 32
RADIUS = 15


def patch_centers(xy: torch.Tensor, H: int, W: int):
    """Clamped integer patch centres: cx in [15, W-18], cy in [15, H-17]
    (``ops/orb.py::_patch_centers``, non-finite xy included)."""
    c = round_clip_xy(xy, (RADIUS, RADIUS), (W - 18, H - 17))
    return c[..., 0], c[..., 1]


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] intensities -> the 0..255 integer grid (float carrier),
    rounding half to even (``ops/orb.py::_quantize_u8``)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0)


def gather_aligned_patches_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) f32, xy (B, N, 2) f32 -> (B, N, 32, 32) bf16
    quantised patches, in plain PyTorch (one flat gather)."""
    B, H, W = img.shape
    N = xy.shape[1]
    cx, cy = patch_centers(xy, H, W)
    d = torch.arange(PATCH, device=img.device) - RADIUS
    rows = (cy[..., None, None] + d[:, None]) * W  # (B, N, 32, 1)
    idx = rows + cx[..., None, None] + d[None, :]  # (B, N, 32, 32)
    flat = quantize_u8(img).reshape(B, H * W)
    out = torch.gather(flat, 1, idx.reshape(B, N * PATCH * PATCH))
    return out.reshape(B, N, PATCH, PATCH).to(torch.bfloat16)


def _check(img: torch.Tensor, xy: torch.Tensor) -> None:
    if img.ndim != 3 or xy.ndim != 3 or xy.shape[-1] != 2 or xy.shape[0] != img.shape[0]:
        raise ValueError(
            f"expected img (B, H, W) and xy (B, N, 2), got {tuple(img.shape)}, {tuple(xy.shape)}"
        )
    if img.dtype != torch.float32 or xy.dtype != torch.float32:
        raise TypeError(f"expected float32 inputs, got {img.dtype}, {xy.dtype}")
    if img.shape[1] < 32 or img.shape[2] < 33:
        raise ValueError(f"frame {tuple(img.shape[1:])} is smaller than a 32x33 patch window")
    if img.device != xy.device:
        raise ValueError(f"img on {img.device} but xy on {xy.device}")


def gather_aligned_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, N, 32, 32) bf16 quantised patches: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(img, xy)
    if img.device.type == "cpu":
        return gather_aligned_patches_plain(img, xy)
    if img.device.type != "cuda":
        raise ValueError(f"gather_aligned_patches: unsupported device {img.device}")
    from . import build

    img = img.contiguous()
    xy = xy.contiguous()
    if xy.data_ptr() % 8:  # the kernel reads each keypoint's xy as one float2
        xy = xy.clone()
    B, H, W = img.shape
    N = xy.shape[1]
    out = torch.empty((B, N, PATCH, PATCH), dtype=torch.bfloat16, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    status = build.library().semslam_aligned_patches(
        img.data_ptr(), xy.data_ptr(), out.data_ptr(), B, N, H, W, stream
    )
    build.check(status, "semslam_aligned_patches")
    gather_aligned_patches.launches += 1
    return out


gather_aligned_patches.launches = 0
