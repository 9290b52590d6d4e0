# Frozen copy of semantic_slam_master_tpu_torch/ops/image.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Batched image primitives (port of ``ops/image.py``): luma, blur, Sobel,
pooling and the antialiased bilinear resize of ``jax.image.resize``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of (..., 3) RGB as one product with the weights, as
    the JAX ``rgb_to_gray`` computes it."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)
    return rgb @ w


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded shift of (B, H, W): ``out[y, x] = img[y - dy, x - dx]``."""
    B, H, W = img.shape
    ay, ax = abs(dy), abs(dx)
    padded = F.pad(img, (ax, ax, ay, ay))
    return padded[:, ay - dy : ay - dy + H, ax - dx : ax - dx + W]


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


def resize_bilinear_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, out_h, out_w, C), "bilinear")`` of a
    channels-last (B, H, W, C) tensor: the same weights as
    ``resize_bilinear``, contracted over H, then W."""
    B, H, W, C = x.shape
    if out_h != H:
        wh = torch.from_numpy(_resize_weights(H, out_h)).to(device=x.device, dtype=x.dtype)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if out_w != W:
        ww = torch.from_numpy(_resize_weights(W, out_w)).to(device=x.device, dtype=x.dtype)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output sample of ``jax.image.resize(...,
    "nearest")``: floor((i + 0.5) * in / out) in f32, with the constant
    folded as XLA folds it, (i + 0.5) * (in * (1 / out)). The exact
    quotient (torch's ``"nearest-exact"``) differs from it: at 480 -> 400
    rows, 80 of the 400 indices."""
    f32 = np.float32
    pos = (np.arange(out_size, dtype=f32) + f32(0.5)) * (f32(in_size) * (f32(1.0) / f32(out_size)))
    return np.floor(pos).astype(np.int64)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (B, out_h, out_w), "nearest")`` of (B, H, W)."""
    B, H, W = img.shape
    if out_h != H:
        img = img[:, torch.from_numpy(_nearest_index(H, out_h)).to(img.device)]
    if out_w != W:
        img = img[:, :, torch.from_numpy(_nearest_index(W, out_w)).to(img.device)]
    return img
