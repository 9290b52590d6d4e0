# Frozen copy of semantic_slam_master_tpu_torch/models/selector.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Keypoint saliency head and fixed-K keypoint selection (port of
``models/selector.py``).

The 3x3 conv stays 9 shifted f32 matmuls, as in the JAX module: a
``conv2d`` sums in another order, and near-ties in saliency then flip the
selection tier and the top-k order. ``select_keypoints`` ranks every
patch by its tier on the percentile ladder, then by score, and takes one
top-k with ``lax.top_k``'s tie order (``core.fixed.masked_topk``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .fixed import masked_topk, quantile
from .image import max_pool_same
from .layers import Dense, default_generator, xavier_uniform

PERCENTILE_LADDER = (0.50, 0.40, 0.30, 0.20, 0.10)
MIN_THRESHOLDS = (0.1, 0.05, 0.05, 0.05, 0.05)


class KeypointSelector(nn.Module):
    """Per-patch saliency in [0, 1]: 3x3 conv (as shifted matmuls) ->
    ReLU -> 1x1 conv -> sigmoid, all f32. ``conv1_kernel`` keeps flax's
    (3, 3, C_in, C_out) layout."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.conv1_kernel = nn.Parameter(
            xavier_uniform((3, 3, in_dim, hidden_dim), in_dim * 9, hidden_dim * 9, gen)
        )
        self.conv1_bias = nn.Parameter(torch.zeros(hidden_dim))
        self.conv2 = Dense(hidden_dim, 1, gen, init="xavier", dtype=torch.float32)
        if device is not None:
            self.to(device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) patch grid -> saliency (B, H, W, 1)."""
        B, H, W, C = features.shape
        padded = F.pad(features.float(), (0, 0, 1, 1, 1, 1))
        x = self.conv1_bias * torch.ones((B, H, W, self.conv1_bias.shape[0]), device=features.device)
        for dy in range(3):
            for dx in range(3):
                window = padded[:, dy : dy + H, dx : dx + W, :]
                x = x + torch.matmul(window, self.conv1_kernel[dy, dx])
        return torch.sigmoid(self.conv2(torch.relu(x)))


class SelectedKeypoints(NamedTuple):
    xy: torch.Tensor  # (B, K, 2) patch coords (x, y)
    score: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K)


def select_keypoints(saliency: torch.Tensor, num_keypoints: int = 500, nms_radius: int = 2) -> SelectedKeypoints:
    """Fixed-K keypoint selection in patch coordinates: NMS survivors above
    the 50th-percentile threshold first (by score), then those above each
    lower percentile, then raw saliency; always exactly K."""
    if saliency.ndim == 4:
        saliency = saliency[..., 0]
    B, H, W = saliency.shape
    flat = saliency.reshape(B, H * W)
    nms = max_pool_same(saliency, nms_radius)
    nms_sal = torch.where(saliency >= nms, saliency, torch.zeros_like(saliency)).reshape(B, H * W)

    num_tiers = len(PERCENTILE_LADDER)
    tier = torch.full((B, H * W), float(num_tiers), device=saliency.device)
    for i in reversed(range(num_tiers)):
        thr = torch.clamp(quantile(flat, PERCENTILE_LADDER[i]), min=MIN_THRESHOLDS[i])
        tier = torch.where(nms_sal > thr[:, None], torch.full_like(tier, float(i)), tier)

    score_for_rank = torch.where(tier < num_tiers, nms_sal, flat)
    rank = -tier * 10.0 + torch.clamp(score_for_rank, 0.0, 1.0)
    _, indices, valid = masked_topk(rank, torch.ones_like(rank, dtype=torch.bool), num_keypoints)
    ys = torch.div(indices, W, rounding_mode="floor").to(torch.float32)
    xs = (indices % W).to(torch.float32)
    scores = torch.gather(flat, 1, indices)
    return SelectedKeypoints(xy=torch.stack([xs, ys], dim=-1), score=scores, valid=valid)


