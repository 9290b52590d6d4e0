# Frozen copy of semantic_slam_master_tpu_torch/slam/tracking.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Frontends feeding the SLAM backend, and frame-to-frame visual odometry
(port of ``slam/tracking.py``): the multi-scale ORB frontend with
optional semantic weight maps and the learned frontend's adapter to
``FrameFeatures``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .segmenter import map_coords
from . import fast, image, orb
from .sampling import nearest_sample

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrameFeatures(NamedTuple):
    """Per-frame frontend output, batched over frames (F leading axis).
    ``desc`` is packed ORB words (int64, Hamming-matched) or learned f32
    descriptors (cosine-matched); ``slam.system.match_features``
    dispatches on the dtype."""

    xy: torch.Tensor  # (F, N, 2) level-0 pixels
    desc: torch.Tensor  # (F, N, 8) int64 packed ORB words or (F, N, D) f32
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
    weight_map: torch.Tensor | None = None,
    num_levels: int = 4,
    scale_factor: float = 1.2,
    subpixel: bool = True,
) -> FrameFeatures:
    """(F, H, W) gray in [0, 1] + metric depth -> FrameFeatures: per level
    FAST detection with NMS and top-k, Gaussian blur, rBRIEF; keypoints
    map back to level-0 pixels and sample depth there.

    ``weight_map`` (F, Hm, Wm), a per-pixel semantic residual weight (e.g.
    ``models.segmenter.class_weights_map``), possibly at a lower
    resolution than the frame: its nearest resize to each level weights
    the corner scores (``detect(score_weight=...)``), and it is sampled at
    the keypoints (pixel-centre rescaled onto its grid) into
    ``sem_weight``."""
    levels = build_pyramid(gray, num_levels, scale_factor)
    quotas = level_quotas([p.shape[1:] for p in levels], num_keypoints)
    H0, W0 = gray.shape[1:]
    xys, descs, scores, valids = [], [], [], []
    for img, quota in zip(levels, quotas):
        w_lvl = None if weight_map is None else image.resize_nearest(weight_map, *img.shape[1:])
        kp = fast.detect(img, int(quota), threshold, nms_radius, subpixel=subpixel, score_weight=w_lvl)
        blurred = image.gaussian_blur(img, sigma=2.0, radius=3)
        descs.append(orb.describe(blurred, kp.xy, prefiltered=True))
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
        sem_weight=torch.ones_like(d) if weight_map is None else sample_weight_map(weight_map, xy, (H0, W0)),
    )


def sample_weight_map(weight_map: torch.Tensor, xy: torch.Tensor, image_size) -> torch.Tensor:
    """Nearest sample of a (F, Hm, Wm) weight map at full-resolution
    keypoints, rescaled pixel-centre aligned when the map is smaller."""
    map_size = tuple(weight_map.shape[1:])
    if map_size != tuple(image_size):
        xy = map_coords(xy, image_size, map_size)
    return nearest_sample(weight_map, xy)


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB -> ImageNet-normalised, as the learned frontend takes it."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=rgb.dtype, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, dtype=rgb.dtype, device=rgb.device)
    return (rgb - mean) / std


def extract_learned_features(
    model,
    rgb: torch.Tensor,
    depth: torch.Tensor,
    weight_map: torch.Tensor | None = None,
    use_confidence: bool = True,
    normalized: bool = False,
) -> FrameFeatures:
    """Learned frontend -> FrameFeatures: ``model`` (a
    ``models.frontend.LearnedFrontend``) on (F, H, W, 3) RGB in [0, 1]
    (ImageNet-normalised here unless ``normalized``), depth (F, H, W)
    sampled at the keypoints. Descriptors come out f32 (cosine-matched
    downstream); ``sem_weight`` is the uncertainty head's confidence (1
    when not ``use_confidence``), times the optional semantic
    ``weight_map``.

    The JAX function samples ``weight_map`` at full-resolution pixels
    whatever its size; a 1/4-resolution map (the segmenter's SLAM path)
    is here rescaled onto its grid first, as ``extract_features`` does.
    For a full-resolution map the two agree."""
    with torch.no_grad():
        out = model(rgb if normalized else normalize_rgb(rgb))
    xy = out.keypoints_px
    d = nearest_sample(depth, xy)
    valid = out.valid & (d > 0.05) & (d < 15.0)
    sem_w = out.confidence if use_confidence else torch.ones_like(d)
    if weight_map is not None:
        sem_w = sem_w * sample_weight_map(weight_map, xy, tuple(rgb.shape[1:3]))
    return FrameFeatures(
        xy=xy,
        desc=out.descriptors.float(),
        depth=d,
        valid=valid,
        score=out.scores,
        sem_weight=sem_w.float(),
    )
