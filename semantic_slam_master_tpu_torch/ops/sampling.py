"""Sampling at keypoints (port of ``ops/sampling.py``): nearest and
bilinear samples of a grid, and the square patch gather, which on a CUDA
tensor is the kernel ``csrc/gather_patches.cu``."""

from __future__ import annotations

import torch

from .kernels.gather_patches import gather_patches  # noqa: F401  (re-exported)


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

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    squeeze = grid.ndim == 3
    if squeeze:
        grid = grid[..., None]
    B, H, W, C = grid.shape
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, H - 1)
    idx = y * W + x  # (B, N)
    out = torch.gather(
        grid.reshape(B, H * W, C), 1, idx[..., None].expand(idx.shape + (C,))
    )
    return out[..., 0] if squeeze else out
