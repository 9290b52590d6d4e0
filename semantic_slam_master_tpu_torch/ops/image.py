"""Batched image primitives (port of ``ops/image.py``): blur, pooling and
the antialiased bilinear resize of ``jax.image.resize``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W), zero-padded, as the same
    shift-add stencil (same taps, same summation order) as the JAX op."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    B, H, W = img.shape
    padded = F.pad(img, (0, 0, radius, radius))
    out = 0
    for i in range(2 * radius + 1):
        out = out + k[i] * padded[:, i : i + H, :]
    padded = F.pad(out, (radius, radius, 0, 0))
    res = 0
    for i in range(2 * radius + 1):
        res = res + k[i] * padded[:, :, i : i + W]
    return res


def max_pool_same(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)x(2r+1) max pooling with SAME (-inf) padding over (B, H, W)."""
    if radius == 0:
        return img
    return F.max_pool2d(img[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis: the triangle kernel, widened by 1/scale when
    downsampling (antialiasing), normalised per output sample, as
    ``jax._src.image.scale.compute_weight_mat`` writes it. XLA compiles
    that expression with fused multiply-adds and reciprocal products of
    its own choosing, so the weights agree to about an ulp, not bit for
    bit."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of (B, H, W), the port of
    ``jax.image.resize(img, (B, out_h, out_w), "bilinear")``, applied as
    two small products (rows then columns)."""
    B, H, W = img.shape
    out = img
    if out_h != H:
        wh = torch.from_numpy(_resize_weights(H, out_h)).to(img.device)
        out = torch.matmul(wh.T, out)  # (B, out_h, W)
    if out_w != W:
        ww = torch.from_numpy(_resize_weights(W, out_w)).to(img.device)
        out = out @ ww  # (B, out_h, out_w)
    return out
