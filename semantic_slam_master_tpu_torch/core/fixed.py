"""Fixed-shape, mask-correct utilities (port of ``core/fixed.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


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
