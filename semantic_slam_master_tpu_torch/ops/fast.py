"""FAST corner detection as fixed-shape batched tensor ops (port of
``ops/fast.py``).

``fast_score`` is the FAST-9 response; on a CUDA tensor it is the kernel
``csrc/fast_score.cu`` (counterpart of the TPU's Pallas kernel), on a CPU
tensor its plain version. ``detect`` adds lexicographic NMS, the 4x4
block-sum recovery of survivors and a fixed-K top-k, as the JAX op does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.fixed import masked_topk
from .image import max_pool_same
from .kernels.fast_score import BORDER_MARGIN, fast_score
from .sampling import nearest_sample


class Keypoints(NamedTuple):
    """Fixed-K keypoint set: xy (B, K, 2), score (B, K), valid (B, K)."""

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor


def _border_mask(h: int, w: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    my = (ys >= margin) & (ys < h - margin)
    mx = (xs >= margin) & (xs < w - margin)
    return my[:, None] & mx[None, :]


def refine_subpixel(score_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sub-pixel positions by a separable parabolic fit on the raw
    response at (x-1, x, x+1) and (y-1, y, y+1), clamped to +/-0.5 px."""

    def axis_offset(sm, sc, sp):
        denom = sm + sp - 2.0 * sc
        off = torch.where(denom < -1e-12, (sm - sp) / (2.0 * denom), torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    e = torch.tensor([1.0, 0.0], dtype=xy.dtype, device=xy.device)
    n = torch.tensor([0.0, 1.0], dtype=xy.dtype, device=xy.device)
    sc = nearest_sample(score_map, xy)
    dx = axis_offset(nearest_sample(score_map, xy - e), sc, nearest_sample(score_map, xy + e))
    dy = axis_offset(nearest_sample(score_map, xy - n), sc, nearest_sample(score_map, xy + n))
    return xy + torch.stack([dx, dy], dim=-1)


def detect(
    gray: torch.Tensor,
    num_keypoints: int,
    threshold: float = 0.08,
    nms_radius: int = 3,
    margin: int = 16,
    subpixel: bool = False,
) -> Keypoints:
    """FAST keypoints with lexicographic (score, index) NMS and fixed-K
    top-k; see the JAX ``detect`` for the design notes."""
    B, H, W = gray.shape
    dev = gray.device
    score = fast_score(gray, threshold)
    raw_score = score
    zero = torch.zeros_like(score)
    pooled = max_pool_same(score, nms_radius)
    is_tied = (score >= pooled) & (score > 0.0)
    idx_f = torch.arange(H * W, dtype=torch.float32, device=dev).reshape(1, H, W).expand(B, H, W)
    tied_idx = torch.where(is_tied, idx_f, torch.full_like(idx_f, -1.0))
    pooled_idx = max_pool_same(tied_idx, nms_radius)
    score = torch.where(is_tied & (idx_f >= pooled_idx), score, zero)
    mask = (score > 0.0) & _border_mask(H, W, max(margin, BORDER_MARGIN), dev)[None]
    masked = torch.where(mask, score, zero)

    if H % 4 == 0 and W % 4 == 0 and nms_radius >= 3:
        # NMS radius >= 3 leaves at most one survivor per 4x4 block, so
        # block sums are exact and sum(v * x) / sum(v) is the survivor's
        # own coordinate.
        xs_w = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        ys_w = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]

        def block_sum(m):
            return m.reshape(B, H // 4, 4, W // 4, 4).sum(dim=(2, 4))

        val = block_sum(masked)
        sx = block_sum(masked * xs_w)
        sy = block_sum(masked * ys_w)
        safe = torch.clamp(val, min=1e-20)
        bx = torch.round(sx / safe).to(torch.int64)
        by = torch.round(sy / safe).to(torch.int64)
        nb = (H // 4) * (W // 4)
        cand_val = val.reshape(B, nb)
        cand_idx = torch.clamp(by * W + bx, 0, H * W - 1).reshape(B, nb)
        values, sel, valid = masked_topk(cand_val, cand_val > 0.0, num_keypoints)
        indices = torch.gather(cand_idx, 1, sel)
    else:
        flat_score = masked.reshape(B, H * W)
        values, indices, valid = masked_topk(flat_score, flat_score > 0.0, num_keypoints)
    ys = torch.div(indices, W, rounding_mode="floor").to(torch.float32)
    xs = (indices % W).to(torch.float32)
    xy = torch.stack([xs, ys], dim=-1)
    if subpixel:
        xy = refine_subpixel(raw_score, xy)
    return Keypoints(xy=xy, score=values, valid=valid)
