"""Square keypoint patch gather: CUDA kernel wrapper and its plain version.

Counterpart of the JAX package's XLA gather ``ops/sampling.py::
gather_patches`` (the learned frontend's sub-patch refinement) and of its
Pallas twin ``ops/pallas/patches.py::gather_patches_pallas``, which no JAX
path calls; the kernel is ``csrc/gather_patches.cu``. Two wrappers share
it:

- ``gather_patches(img, centers, radius)``: (B, N, 2r+1, 2r+1) windows at
  the rounded centres, clamped to [r, W-1-r] x [r, H-1-r] (the learned
  frontend's sub-patch refinement calls it with r = 10);
- ``gather_patches_padded(img, centers, radius)``: the Pallas kernel's
  (B, N, 32, 32) windows, clamped one pixel tighter on the bottom and
  right, to [r, W-(32-r)] x [r, H-(32-r)]; its [:2r+1, :2r+1] prefix
  equals ``gather_patches`` wherever the clamps agree.

Both are pure copies, so kernel and plain version give the same bits.
"""

from __future__ import annotations

import torch

from ...core.fixed import round_clip_xy

PADDED_SIDE = 32


def window_bounds(img: torch.Tensor, radius: int, side: int):
    """Clamp bounds (x_lo, x_hi, y_lo, y_hi) of a side x side window whose
    centre sits ``radius`` pixels from its top-left corner."""
    H, W = img.shape[1:]
    return radius, W - side + radius, radius, H - side + radius


def window_index(centers, W: int, radius: int, side: int, x_lo, x_hi, y_lo, y_hi) -> torch.Tensor:
    """(B, N, 2) centres -> (B, N * side * side) flat pixel indices of the
    windows with their top-left corner at (cx - r, cy - r) in a frame of
    width W. Centres round half to even and clamp as in JAX, non-finite
    ones included (``round_clip_xy``)."""
    B, N = centers.shape[:2]
    c = round_clip_xy(centers, (x_lo, y_lo), (x_hi, y_hi))
    cx, cy = c[..., 0], c[..., 1]
    d = torch.arange(side, device=centers.device) - radius
    rows = (cy[..., None, None] + d[:, None]) * W  # (B, N, side, 1)
    return (rows + cx[..., None, None] + d[None, :]).reshape(B, N * side * side)


def _check(img: torch.Tensor, centers: torch.Tensor, radius: int, side: int) -> None:
    if img.ndim != 3 or centers.ndim != 3 or centers.shape[-1] != 2 or centers.shape[0] != img.shape[0]:
        raise ValueError(
            f"expected img (B, H, W) and centers (B, N, 2), got {tuple(img.shape)}, "
            f"{tuple(centers.shape)}"
        )
    if img.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"expected float32 inputs, got {img.dtype}, {centers.dtype}")
    if radius < 0 or 2 * radius + 1 > side:
        raise ValueError(f"radius {radius}: a {2 * radius + 1}-pixel window does not fit a side of {side}")
    if img.shape[1] < side or img.shape[2] < side:
        raise ValueError(f"frame {tuple(img.shape[1:])} is smaller than a {side}x{side} window")
    if img.device != centers.device:
        raise ValueError(f"img on {img.device} but centers on {centers.device}")


def _launch(img, centers, radius: int, side: int, name: str) -> torch.Tensor:
    if img.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img.device}")
    from . import build

    img = img.contiguous()
    centers = centers.contiguous()
    B, H, W = img.shape
    N = centers.shape[1]
    out = torch.empty((B, N, side, side), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    status = build.library().semslam_gather_patches(
        img.data_ptr(), centers.data_ptr(), out.data_ptr(), B, N, H, W,
        radius, side, *window_bounds(img, radius, side), stream,
    )
    build.check(status, "semslam_gather_patches")
    return out


def gather_patches(img: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, N, 2r+1, 2r+1) f32 windows at the rounded centres: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    side = 2 * radius + 1
    if img.device.type == "cpu":
        return gather_patches_reference(img, centers, radius, side)
    _check(img, centers, radius, side)
    out = _launch(img, centers, radius, side, "gather_patches")
    gather_patches.launches += 1
    return out


def gather_patches_padded(img: torch.Tensor, centers: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """(B, N, 32, 32) f32 windows with the Pallas kernel's clamp: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if img.device.type == "cpu":
        return gather_patches_reference(img, centers, radius, PADDED_SIDE)
    _check(img, centers, radius, PADDED_SIDE)
    out = _launch(img, centers, radius, PADDED_SIDE, "gather_patches_padded")
    gather_patches_padded.launches += 1
    return out


def gather_patches_reference(img: torch.Tensor, centers: torch.Tensor, radius: int, side: int) -> torch.Tensor:
    """The plain version of either wrapper (side 2r+1 or 32), on any
    device: (B, H, W), (B, N, 2) -> (B, N, side, side) in one flat gather."""
    _check(img, centers, radius, side)
    B, H, W = img.shape
    idx = window_index(centers, W, radius, side, *window_bounds(img, radius, side))
    out = torch.gather(img.reshape(B, H * W), 1, idx)
    return out.reshape(B, centers.shape[1], side, side)


gather_patches.launches = 0
gather_patches_padded.launches = 0
