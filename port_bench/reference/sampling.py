# Frozen copy of semantic_slam_master_tpu_torch/ops/sampling.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Sampling at keypoints (port of ``ops/sampling.py``): nearest and
bilinear samples of a grid, and the square patch gather, which on a CUDA
tensor is the kernel ``csrc/gather_patches.cu``."""

from __future__ import annotations

import torch

from .fixed import round_clip_xy


def bilinear_sample(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) grids at (B, N, 2) float (x, y) grid coords ->
    (B, N, C); coordinates clamp to the border (``grid_sample`` with
    ``align_corners=True``). Same lerp order as the JAX op."""
    B, H, W, C = grid.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(H - 2, 0))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]
    flat = grid.reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy * W + xx)[..., None].expand(B, xx.shape[1], C)
        return torch.gather(flat, 1, idx)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def nearest_sample(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sampling of (B, H, W[, C]) at (B, N, 2) coords.

    Coordinates round half to even and clamp as in JAX, non-finite ones
    included (``round_clip_xy``)."""
    squeeze = grid.ndim == 3
    if squeeze:
        grid = grid[..., None]
    B, H, W, C = grid.shape
    c = round_clip_xy(xy, (0, 0), (W - 1, H - 1))
    idx = c[..., 1] * W + c[..., 0]  # (B, N)
    out = torch.gather(
        grid.reshape(B, H * W, C), 1, idx[..., None].expand(idx.shape + (C,))
    )
    return out[..., 0] if squeeze else out


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


def gather_patches_reference(img: torch.Tensor, centers: torch.Tensor, radius: int, side: int) -> torch.Tensor:
    """The plain version of either wrapper (side 2r+1 or 32), on any
    device: (B, H, W), (B, N, 2) -> (B, N, side, side) in one flat gather."""
    B, H, W = img.shape
    idx = window_index(centers, W, radius, side, *window_bounds(img, radius, side))
    out = torch.gather(img.reshape(B, H * W), 1, idx)
    return out.reshape(B, centers.shape[1], side, side)


def gather_patches(img: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, N, 2r+1, 2r+1) windows at the rounded centres."""
    return gather_patches_reference(img, centers, radius, 2 * radius + 1)
