"""The metrics of the four acceptance tests, frontend-agnostic (numpy copy
of ``eval/metrics.py``, with ``benchmark_stages`` timed by
``utils/profiling.py``):

- repeatability (>= 60%): warped keypoints with a frame-2 keypoint within
  3 px, under a depth reprojection or a rotation-only homography;
- descriptor quality (inlier ratio >= 80%, precision >= 70%): mutual-NN
  matches against the ground-truth warp;
- tracking success (>= 90%): sequential steps with a minimum match count;
- performance (>= 20 FPS): the marginal time per call of each stage.

Each function takes plain numpy arrays, so it serves the ORB and the
learned frontend alike.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

DEFAULT_TARGETS = {
    "repeatability": 0.60,
    "inlier_ratio": 0.80,
    "precision": 0.70,
    "tracking_success": 0.90,
    "fps": 20.0,
}


def rotation_homography_np(K: np.ndarray, T_rel: np.ndarray) -> np.ndarray:
    """H = K R K^-1 from a relative pose, the reference's small-motion GT
    approximation (`test_repeatability.py:188-192`)."""
    R = T_rel[:3, :3]
    return K @ R @ np.linalg.inv(K)


def warp_points(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    w = homo @ H.T
    return w[:, :2] / np.maximum(np.abs(w[:, 2:3]), 1e-12) * np.sign(w[:, 2:3])


def repeatability(
    kpts1: np.ndarray,
    kpts2: np.ndarray,
    H: np.ndarray,
    threshold: float = 3.0,
    bounds: tuple | None = None,
) -> Dict[str, float]:
    """Fraction of frame-1 keypoints whose warp lands within ``threshold``
    px of some frame-2 keypoint. kpts: (N, 2) pixel coords."""
    warped = warp_points(H, np.asarray(kpts1, dtype=np.float64))
    if bounds is not None:
        w, h = bounds
        keep = (
            (warped[:, 0] >= 0) & (warped[:, 0] < w)
            & (warped[:, 1] >= 0) & (warped[:, 1] < h)
        )
        warped = warped[keep]
    if len(warped) == 0 or len(kpts2) == 0:
        return {"repeatability": 0.0, "mean_nn_distance": float("inf"), "num_visible": 0}
    d = np.linalg.norm(warped[:, None, :] - np.asarray(kpts2)[None, :, :], axis=2)
    nn = d.min(axis=1)
    return {
        "repeatability": float((nn < threshold).mean()),
        "mean_nn_distance": float(nn.mean()),
        "num_visible": int(len(warped)),
    }


def reproject_with_depth(
    kpts: np.ndarray,
    depth_map: np.ndarray,
    T_12: np.ndarray,
    K: np.ndarray,
) -> tuple:
    """Exact GT warp of frame-1 keypoints into frame 2 using the depth map.

    Unlike the reference's rotation-only homography (valid only for
    near-zero translation), this handles arbitrary motion. Returns
    (warped (N, 2), visible (N,) bool: positive depth both frames).
    """
    kpts = np.asarray(kpts, dtype=np.float64)
    u = np.clip(np.round(kpts[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
    v = np.clip(np.round(kpts[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
    z = np.asarray(depth_map, dtype=np.float64)[v, u]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (kpts[:, 0] - cx) / fx * z
    y = (kpts[:, 1] - cy) / fy * z
    pts1 = np.stack([x, y, z], axis=-1)
    pts2 = pts1 @ T_12[:3, :3].T + T_12[:3, 3]
    z2 = pts2[:, 2]
    visible = (z > 1e-3) & (z2 > 1e-3)
    z2_safe = np.where(np.abs(z2) < 1e-9, 1e-9, z2)
    warped = np.stack(
        [fx * pts2[:, 0] / z2_safe + cx, fy * pts2[:, 1] / z2_safe + cy], axis=-1
    )
    return warped, visible


def nn_agreement(
    warped: np.ndarray, kpts2: np.ndarray, threshold: float
) -> Dict[str, float]:
    """Repeatability core: fraction of warped points with a frame-2
    keypoint within threshold."""
    if len(warped) == 0 or len(kpts2) == 0:
        return {"repeatability": 0.0, "mean_nn_distance": float("inf"), "num_visible": 0}
    d = np.linalg.norm(warped[:, None, :] - np.asarray(kpts2)[None, :, :], axis=2)
    nn = d.min(axis=1)
    return {
        "repeatability": float((nn < threshold).mean()),
        "mean_nn_distance": float(nn.mean()),
        "num_visible": int(len(warped)),
    }


def gt_matches_from_warp(
    warped1: np.ndarray,
    visible1: np.ndarray,
    kpts2: np.ndarray,
    threshold: float = 3.0,
) -> np.ndarray:
    """GT matches given precomputed warped frame-1 keypoints."""
    if len(kpts2) == 0:
        return np.zeros((0, 2), int)
    d = np.linalg.norm(
        warped1[:, None, :] - np.asarray(kpts2)[None, :, :], axis=2
    )
    nn_d = d.min(axis=1)
    nn_i = d.argmin(axis=1)
    ok = (nn_d < threshold) & visible1
    idx1 = np.where(ok)[0]
    return np.stack([idx1, nn_i[idx1]], axis=1) if len(idx1) else np.zeros((0, 2), int)


def match_quality_from_warp(
    pred_matches: np.ndarray,
    gt_matches: np.ndarray,
    warped1: np.ndarray,
    kpts2: np.ndarray,
    inlier_threshold: float = 3.0,
) -> Dict[str, float]:
    """Precision/recall/F1 + geometric inlier ratio against a precomputed
    GT warp (depth-reprojection or homography)."""
    gt_set = {tuple(m) for m in np.asarray(gt_matches)}
    pred = np.asarray(pred_matches)
    if len(pred) == 0:
        return {
            "precision": 0.0, "recall": 0.0, "f1": 0.0,
            "inlier_ratio": 0.0, "num_matches": 0,
        }
    correct = sum(tuple(m) in gt_set for m in pred)
    precision = correct / len(pred)
    recall = correct / max(len(gt_set), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    d = np.linalg.norm(
        warped1[pred[:, 0]] - np.asarray(kpts2)[pred[:, 1]], axis=1
    )
    return {
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "inlier_ratio": float((d < inlier_threshold).mean()),
        "num_matches": int(len(pred)),
    }


def gt_matches_from_homography(
    kpts1: np.ndarray, kpts2: np.ndarray, H: np.ndarray, threshold: float = 3.0
) -> np.ndarray:
    """Pose-derived ground-truth matches (`test_descriptor_quality.py:144-185`):
    warp kpts1, take the nearest kpt2 within threshold."""
    warped = warp_points(H, np.asarray(kpts1, dtype=np.float64))
    d = np.linalg.norm(warped[:, None, :] - np.asarray(kpts2)[None, :, :], axis=2)
    nn_d = d.min(axis=1)
    nn_i = d.argmin(axis=1)
    idx1 = np.where(nn_d < threshold)[0]
    return np.stack([idx1, nn_i[idx1]], axis=1) if len(idx1) else np.zeros((0, 2), int)


def match_quality(
    pred_matches: np.ndarray,
    gt_matches: np.ndarray,
    kpts1: np.ndarray,
    kpts2: np.ndarray,
    H: np.ndarray,
    inlier_threshold: float = 3.0,
) -> Dict[str, float]:
    """Precision / recall / F1 vs GT matches + geometric inlier ratio
    (`test_descriptor_quality.py:187-231`)."""
    gt_set = {tuple(m) for m in np.asarray(gt_matches)}
    pred = np.asarray(pred_matches)
    if len(pred) == 0:
        return {
            "precision": 0.0, "recall": 0.0, "f1": 0.0,
            "inlier_ratio": 0.0, "num_matches": 0,
        }
    correct = sum(tuple(m) in gt_set for m in pred)
    precision = correct / len(pred)
    recall = correct / max(len(gt_set), 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)

    # Geometric inliers: predicted match whose warped kpt1 is close to its
    # matched kpt2 (independent of the GT NN assignment).
    warped = warp_points(H, np.asarray(kpts1, dtype=np.float64)[pred[:, 0]])
    d = np.linalg.norm(warped - np.asarray(kpts2)[pred[:, 1]], axis=1)
    return {
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "inlier_ratio": float((d < inlier_threshold).mean()),
        "num_matches": int(len(pred)),
    }


def tracking_success(
    match_counts: Sequence[int], min_matches: int = 50
) -> Dict[str, float]:
    """Success rate of sequential tracking steps (`test_tracking.py:159-177`)."""
    counts = np.asarray(list(match_counts))
    if len(counts) == 0:
        return {"success_rate": 0.0, "mean_matches": 0.0, "num_steps": 0}
    return {
        "success_rate": float((counts >= min_matches).mean()),
        "mean_matches": float(counts.mean()),
        "min_matches": int(counts.min()),
        "num_steps": int(len(counts)),
    }


def benchmark_stages(
    stages: Dict[str, tuple],
    warmup: int = 3,
    iters: int = 10,
) -> Dict[str, Dict[str, float]]:
    """Per-stage latency: each stage ``(fn, args)`` timed as the marginal
    time per call between two back-to-back run lengths
    (``utils.profiling.marginal_time_ms``, CUDA events on the card), plus
    their ``total`` and its fps."""
    from ..utils.profiling import marginal_time_ms

    del warmup  # folded into marginal_time_ms
    results: Dict[str, Dict[str, float]] = {}
    for name, (fn, args) in stages.items():
        results[name] = marginal_time_ms(fn, args, iters=max(iters, 8))
    total = sum(r["mean_ms"] for r in results.values())
    results["total"] = {"mean_ms": total, "fps": 1000.0 / max(total, 1e-9)}
    return results


def check_targets(results: Dict[str, float], targets: Dict[str, float] | None = None):
    """Pass/fail summary against the reference thresholds."""
    targets = {**DEFAULT_TARGETS, **(targets or {})}
    report = {}
    for key, target in targets.items():
        if key in results:
            report[key] = {
                "value": results[key],
                "target": target,
                "passed": bool(results[key] >= target),
            }
    return report
