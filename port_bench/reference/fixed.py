# Frozen copy of semantic_slam_master_tpu_torch/core/fixed.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Fixed-shape, mask-correct utilities (port of ``core/fixed.py``)."""

from __future__ import annotations

import functools
from typing import Tuple

import torch

NEG_INF = -1e30


def round_clip_xy(xy: torch.Tensor, lo: Tuple[int, int], hi: Tuple[int, int]) -> torch.Tensor:
    """``jnp.clip(jnp.round(xy).astype(jnp.int32), lo, hi)`` as XLA computes
    it, on (..., 2) coordinates with per-axis bounds ``lo = (x_lo, y_lo)``,
    ``hi = (x_hi, y_hi)``, as int64: round half to even, NaN to 0, then
    clamp. XLA's float-to-int32 conversion saturates, so +inf and values
    past the int32 range land on the high bound and -inf on the low one; a
    cast before the clamp would send +inf to the low bound on the CPU. Here
    the clamp runs in float, before the cast, as the CUDA kernels do: four
    elementwise launches for x and y together."""
    lo_t, hi_t = _bounds(tuple(lo), tuple(hi), xy.dtype, xy.device)
    v = torch.nan_to_num(torch.round(xy), nan=0.0)
    return torch.clamp(v, lo_t, hi_t).to(torch.int64)


@functools.lru_cache(maxsize=64)
def _bounds(lo, hi, dtype, device):
    """(2,) bound tensors on ``device``, made once per frame size: a fresh
    host-to-device copy would wait for the stream at every call."""
    return torch.tensor(lo, dtype=dtype, device=device), torch.tensor(hi, dtype=dtype, device=device)


def masked_topk(
    scores: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of ``scores`` restricted to ``mask``; always returns exactly k.

    Returns ``(values, indices, valid)``; invalid slots repeat the best
    candidate. Ties are ordered lower index first, as ``lax.top_k`` does
    (``torch.topk`` does not promise that), via a stable descending sort.
    """
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    n = masked.shape[-1]
    if k > n:
        pad = masked.new_full(masked.shape[:-1] + (k - n,), NEG_INF)
        masked = torch.cat([masked, pad], dim=-1)
    values, indices = torch.sort(masked, dim=-1, descending=True, stable=True)
    values, indices = values[..., :k], indices[..., :k]
    indices = torch.clamp(indices, max=n - 1)
    valid = values > NEG_INF / 2
    indices = torch.where(valid, indices, indices[..., :1])
    values = torch.where(valid, values, values[..., :1])
    return values, indices, valid


def quantile(x: torch.Tensor, q: float, dim: int = -1) -> torch.Tensor:
    """Linear-interpolation quantile along ``dim``, in the arithmetic of
    ``jnp.quantile(method="linear")`` as XLA compiles it on the CPU: sort,
    position q * (n - 1) in f32, then ``fma(low, 1 - w, high * w)`` (the
    fused multiply-add taken exactly in f64 and rounded once to f32). A
    slice holding a NaN gives NaN. Takes float32."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    pos = torch.tensor(q, dtype=x.dtype) * torch.tensor(n - 1, dtype=x.dtype)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo = srt[..., int(low.clamp(0, n - 1))]
    hi = srt[..., int(high.clamp(0, n - 1))]
    hi_w = hi * hw.to(x.device)
    out = (lo.double() * lw.double().to(x.device) + hi_w.double()).to(x.dtype)
    return torch.where(torch.isnan(x).any(dim=-1), torch.full_like(out, float("nan")), out)


def inv3x3(V: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = torch.where(det.abs() > eps, 1.0 / det, torch.zeros_like(det))
    rows = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return rows * inv_det[..., None, None]
