"""Nearest-neighbour sampling at keypoints (port of ``ops/sampling.py``)."""

from __future__ import annotations

import torch


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
