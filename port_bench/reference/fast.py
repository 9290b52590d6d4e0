# Frozen copy of semantic_slam_master_tpu_torch/ops/fast.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
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

from .fixed import masked_topk
from .image import max_pool_same
from .sampling import nearest_sample

import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER_MARGIN = 3


def _arc9(word: torch.Tensor) -> torch.Tensor:
    """Nonzero where any 9 circularly contiguous of the 16 bits are set."""
    d = word | (word << 16)
    c3 = d & (d >> 1) & (d >> 2)
    c9 = c3 & (c3 >> 3) & (c3 >> 6)
    return (c9 & 0xFFFF) != 0


def fast_score_plain(gray: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """(B, H, W) f32 in [0, 1] -> (B, H, W) f32 FAST-9 response, in plain
    PyTorch: a loop over the 16 circle points in the kernel's order."""
    B, H, W = gray.shape
    r = BORDER_MARGIN
    padded = F.pad(gray, (r, r, r, r))
    word_b = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    word_d = torch.zeros_like(word_b)
    bright = torch.zeros_like(gray)
    dark = torch.zeros_like(gray)
    for i, (dy, dx) in enumerate(FAST_CIRCLE):
        diff = padded[:, r + dy : r + dy + H, r + dx : r + dx + W] - gray
        word_b |= (diff > threshold).to(torch.int64) << i
        word_d |= (diff < -threshold).to(torch.int64) << i
        bright = bright + torch.clamp(diff - threshold, min=0.0)
        dark = dark + torch.clamp(-diff - threshold, min=0.0)
    is_b = _arc9(word_b)
    is_d = _arc9(word_d)
    zero = torch.zeros_like(gray)
    score = torch.where(is_b, bright, zero) + torch.where(is_d, dark, zero)
    return torch.where(is_b | is_d, score, zero)


def fast_candidates_plain(gray: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """(B, H, W) bool: the pixels that pass the kernel's 4-point test, in
    plain PyTorch. Any arc of 9 of the 16 circle points holds two
    circularly adjacent compass points (circle indices 0, 4, 8, 12) of its
    polarity, so a pixel outside this mask has a response of exactly 0 and
    the kernel skips its 16-point chain."""
    B, H, W = gray.shape
    r = BORDER_MARGIN
    padded = F.pad(gray, (r, r, r, r))
    diffs = [padded[:, r + dy : r + dy + H, r + dx : r + dx + W] - gray for dy, dx in FAST_CIRCLE[::4]]

    def adjacent_pair(bits):  # (b0 & b4) | (b4 & b8) | (b8 & b12) | (b12 & b0)
        return (bits[0] | bits[2]) & (bits[1] | bits[3])

    return adjacent_pair([d > threshold for d in diffs]) | adjacent_pair([d < -threshold for d in diffs])


fast_score = fast_score_plain


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
    score_weight: torch.Tensor | None = None,
) -> Keypoints:
    """FAST keypoints with lexicographic (score, index) NMS and fixed-K
    top-k; see the JAX ``detect`` for the design notes. ``score_weight``
    (B, H, W) multiplies the corner scores before NMS and top-k; the
    sub-pixel fit still uses the raw response."""
    B, H, W = gray.shape
    dev = gray.device
    score = fast_score(gray, threshold)
    raw_score = score
    if score_weight is not None:
        score = score * score_weight
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
