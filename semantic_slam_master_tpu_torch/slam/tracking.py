"""Multi-scale ORB frontend (port of ``slam/tracking.py``'s
``build_pyramid`` and ``extract_features``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import fast, image, orb
from ..ops.sampling import nearest_sample


class FrameFeatures(NamedTuple):
    """Per-frame frontend output, batched over frames (F leading axis)."""

    xy: torch.Tensor  # (F, N, 2) level-0 pixels
    desc: torch.Tensor  # (F, N, 8) int64 packed ORB words
    depth: torch.Tensor  # (F, N) metric depth at keypoints
    valid: torch.Tensor  # (F, N) bool
    score: torch.Tensor  # (F, N)
    sem_weight: torch.Tensor  # (F, N) residual weight (1 without semantics)


def pyramid_shapes(H: int, W: int, num_levels: int, scale_factor: float = 1.2):
    """Level shapes: heights rounded to multiples of 8, widths to 32."""
    shapes = [(H, W)]
    for i in range(1, num_levels):
        h = max(int(round(H / scale_factor**i / 8)) * 8, 24)
        w = max(int(round(W / scale_factor**i / 32)) * 32, 32)
        shapes.append((h, w))
    return shapes


def build_pyramid(gray: torch.Tensor, num_levels: int, scale_factor: float = 1.2) -> list:
    """Image pyramid, each level the antialiased bilinear resize of the
    previous one (as ``jax.image.resize(..., "bilinear")``)."""
    levels = [gray]
    for h, w in pyramid_shapes(gray.shape[1], gray.shape[2], num_levels, scale_factor)[1:]:
        levels.append(image.resize_bilinear(levels[-1], h, w))
    return levels


def level_quotas(shapes, num_keypoints: int) -> np.ndarray:
    """Area-proportional keypoint quota per level (remainder to level 0)."""
    areas = np.array([h * w for h, w in shapes], dtype=np.float64)
    quotas = np.maximum((num_keypoints * areas / areas.sum()).astype(int), 1)
    quotas[0] += num_keypoints - int(quotas.sum())
    return quotas


def extract_features(
    gray: torch.Tensor,
    depth: torch.Tensor,
    num_keypoints: int = 512,
    threshold: float = 0.05,
    nms_radius: int = 3,
    num_levels: int = 4,
    scale_factor: float = 1.2,
    subpixel: bool = True,
) -> FrameFeatures:
    """(F, H, W) gray in [0, 1] + metric depth -> FrameFeatures: per level
    FAST detection with NMS and top-k, Gaussian blur, rBRIEF; keypoints
    map back to level-0 pixels and sample depth there."""
    levels = build_pyramid(gray, num_levels, scale_factor)
    quotas = level_quotas([p.shape[1:] for p in levels], num_keypoints)
    H0, W0 = gray.shape[1:]
    xys, descs, scores, valids = [], [], [], []
    for img, quota in zip(levels, quotas):
        kp = fast.detect(img, int(quota), threshold, nms_radius, subpixel=subpixel)
        blurred = image.gaussian_blur(img, sigma=2.0, radius=3)
        descs.append(orb.describe(blurred, kp.xy))
        ry = (H0 - 1) / max(img.shape[1] - 1, 1)
        rx = (W0 - 1) / max(img.shape[2] - 1, 1)
        xys.append(kp.xy * torch.tensor([rx, ry], dtype=kp.xy.dtype, device=kp.xy.device))
        scores.append(kp.score)
        valids.append(kp.valid)
    xy = torch.cat(xys, dim=1)
    d = nearest_sample(depth, xy)
    valid = torch.cat(valids, dim=1) & (d > 0.05) & (d < 15.0)
    return FrameFeatures(
        xy=xy,
        desc=torch.cat(descs, dim=1),
        depth=d,
        valid=valid,
        score=torch.cat(scores, dim=1),
        sem_weight=torch.ones_like(d),
    )
