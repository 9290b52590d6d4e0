"""The four-test acceptance suite on any frontend (port of
``eval/frontend_tests.py``): repeatability, descriptor quality, tracking
and performance, with the difficulty presets and the train/test overlap
guard, over the ORB frontend (single-scale or the SLAM path's pyramid) or
a learned frontend, on TUM sequences or the synthetic world.

An adapter runs its frontend on ``device`` and hands numpy arrays to the
metrics; its ``stages`` give the performance test tensors on ``device``.
Frame 1's keypoints go to frame 2 by the relative camera transform
``T2^-1 T1`` of the camera-in-world poses, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.camera import PinholeCamera
from . import metrics

DIFFICULTY_PRESETS = {
    "easy": {"spacings": (1,), "min_matches": 30, "num_pairs": 10},
    "normal": {"spacings": (1, 5), "min_matches": 50, "num_pairs": 20},
    "hard": {"spacings": (1, 5, 10), "min_matches": 50, "num_pairs": 30},
    "extreme": {"spacings": (1, 5, 10, 20), "min_matches": 60, "num_pairs": 50},
}


@dataclass
class FrontendAdapter:
    """Uniform view of a feature frontend for the acceptance tests.

    extract(rgb) -> dict of numpy arrays 'xy' (F, N, 2) pixel keypoints,
    'desc' (F, N, D), 'valid' (F, N); rgb is (F, H, W, 3) float [0, 1].
    match(feats, i, j) -> (K, 2) int array of matches between frames i
    and j of an extract() result. stages(rgb) -> {name: (fn, args)}.
    """

    name: str
    extract: Callable[[np.ndarray], Dict[str, np.ndarray]]
    match: Callable[[Dict[str, np.ndarray], int, int], np.ndarray]
    stages: Optional[Callable[[np.ndarray], Dict[str, tuple]]] = None


def _numpy(**tensors) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in tensors.items()}


def _valid_pairs(m) -> np.ndarray:
    valid = m.valid.cpu().numpy()
    idx1 = np.where(valid)[0]
    return np.stack([idx1, m.idx2.cpu().numpy()[idx1]], axis=1)


def _hamming_match(device, max_distance):
    from ..ops import matching

    def match(feats: Dict[str, np.ndarray], i: int, j: int) -> np.ndarray:
        d1, d2 = (torch.from_numpy(np.asarray(feats["desc"][n])).to(device) for n in (i, j))
        v1, v2 = (torch.from_numpy(np.asarray(feats["valid"][n])).to(device) for n in (i, j))
        return _valid_pairs(matching.match_hamming(d1, d2, v1, v2, max_distance=max_distance))

    return match


def orb_adapter(num_keypoints: int = 500, threshold: float = 0.05, max_distance: float = 64.0,
                device: str | torch.device = "cuda") -> FrontendAdapter:
    """The single-scale ORB frontend (FAST, blur, rBRIEF, Hamming matching)."""
    from ..ops import fast, image, matching, orb

    device = torch.device(device)

    def gray_of(rgb):
        return image.rgb_to_gray(torch.from_numpy(np.asarray(rgb)).to(device))

    def extract(rgb: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            gray = gray_of(rgb)
            blurred = image.gaussian_blur(gray, sigma=2.0, radius=3)
            kp = fast.detect(gray, num_keypoints, threshold)
            desc = orb.describe(blurred, kp.xy, prefiltered=True)
        return _numpy(xy=kp.xy, desc=desc, valid=kp.valid)

    def stages(rgb: np.ndarray) -> Dict[str, tuple]:
        with torch.no_grad():
            gray = gray_of(rgb)
            blurred = image.gaussian_blur(gray, sigma=2.0, radius=3)
            kp = fast.detect(gray, num_keypoints, threshold)
            desc = orb.describe(blurred, kp.xy, prefiltered=True)
        return {
            "fast_detect": (lambda g: fast.detect(g, num_keypoints, threshold).xy, (gray,)),
            "orb_describe": (lambda b, xy: orb.describe(b, xy, prefiltered=True), (blurred, kp.xy)),
            "hamming_match": (lambda d: matching.match_hamming(d, d).idx2, (desc,)),
        }

    return FrontendAdapter("orb", extract, _hamming_match(device, max_distance), stages)


def pyramid_orb_adapter(
    num_keypoints: int = 500,
    threshold: float = 0.05,
    max_distance: float = 64.0,
    num_levels: int = 4,
    scale_factor: float = 1.2,
    device: str | torch.device = "cuda",
) -> FrontendAdapter:
    """The SLAM path's multi-scale ORB frontend, ``tracking.extract_features``
    (4-level pyramid by default). The suite hands it no depth, so a
    keypoint's validity is the detector's."""
    from ..ops import image, matching
    from ..slam import tracking

    device = torch.device(device)

    def gray_of(rgb):
        gray = image.rgb_to_gray(torch.from_numpy(np.asarray(rgb)).to(device))
        return gray[None] if gray.ndim == 2 else gray

    def ext(g, d):
        return tracking.extract_features(g, d, num_keypoints=num_keypoints, threshold=threshold,
                                         num_levels=num_levels, scale_factor=scale_factor)

    def extract(rgb: np.ndarray) -> Dict[str, np.ndarray]:
        # A batch (F, H, W, 3) gives per-frame (F, K, ...) arrays; one
        # (H, W, 3) frame gives (K, ...).
        with torch.no_grad():
            gray = gray_of(rgb)
            f = ext(gray, torch.ones_like(gray))
        sel = 0 if np.asarray(rgb).ndim == 3 else slice(None)
        return _numpy(xy=f.xy[sel], desc=f.desc[sel], valid=f.valid[sel])

    def stages(rgb: np.ndarray) -> Dict[str, tuple]:
        with torch.no_grad():
            gray = gray_of(rgb)
            ones = torch.ones_like(gray)
            f = ext(gray, ones)
        return {
            "pyramid_extract": (lambda g, d: ext(g, d).xy, (gray, ones)),
            "hamming_match": (
                lambda d, v: matching.match_hamming(d[0], d[-1], v[0], v[-1], max_distance=max_distance).idx2,
                (f.desc, f.valid),
            ),
        }

    return FrontendAdapter(f"orb_pyramid{num_levels}", extract, _hamming_match(device, max_distance), stages)


def learned_adapter(model, ratio: float = 0.9, min_similarity: float | None = None, normalized: bool = False,
                    input_size: int | None = None, device: str | torch.device | None = None) -> FrontendAdapter:
    """A ``LearnedFrontend`` (already on ``device``) as an adapter, with
    cosine mutual-NN + ratio matching.

    ``normalized``: the inputs are already ImageNet-normalised; otherwise
    [0, 1] RGB is normalised here (the model is trained on normalised
    input). ``input_size``: frames are resized to (input_size,
    input_size), the model's training resolution, by the antialiased
    bilinear resize of ``jax.image.resize``, and the keypoints mapped back
    to native pixels."""
    from ..models.selector import select_keypoints
    from ..ops import image, matching
    from ..slam.tracking import normalize_rgb

    device = torch.device(device) if device is not None else next(model.parameters()).device

    def prepare(rgb):
        x = torch.from_numpy(np.asarray(rgb)).to(device)
        if input_size is not None:
            x = image.resize_bilinear_nhwc(x, input_size, input_size)
        return x if normalized else normalize_rgb(x)

    def extract(rgb: np.ndarray) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            out = model(prepare(rgb))
        res = _numpy(xy=out.keypoints_px, desc=out.descriptors, valid=out.valid, scores=out.scores,
                     confidence=out.confidence)
        if input_size is not None:
            H, W = rgb.shape[1:3]
            res["xy"] = res["xy"] * np.asarray([(W - 1) / (input_size - 1), (H - 1) / (input_size - 1)],
                                               res["xy"].dtype)
        return res

    def match(feats: Dict[str, np.ndarray], i: int, j: int) -> np.ndarray:
        d1, d2 = (torch.from_numpy(np.asarray(feats["desc"][n])).to(device) for n in (i, j))
        v1, v2 = (torch.from_numpy(np.asarray(feats["valid"][n])).to(device) for n in (i, j))
        return _valid_pairs(matching.match_cosine(d1, d2, v1, v2, ratio=ratio, min_similarity=min_similarity))

    def stages(rgb: np.ndarray) -> Dict[str, tuple]:
        with torch.no_grad():
            imgs = prepare(rgb)
            feats, sal = model.features_and_saliency(imgs)
            kp = select_keypoints(sal, model.num_keypoints)
        return {
            "backbone": (lambda x: model.features_and_saliency(x)[0], (imgs,)),
            "select_keypoints": (lambda s: select_keypoints(s, model.num_keypoints).xy, (sal,)),
            "describe_refine": (lambda f, xy: model.describe_at(f, xy)[1], (feats, kp.xy)),
        }

    return FrontendAdapter("learned", extract, match, stages)


# ---------------------------------------------------------------------------
# Sequence access
# ---------------------------------------------------------------------------


def _relative_cam_transform(pose1_wc: np.ndarray, pose2_wc: np.ndarray) -> np.ndarray:
    """cam1 -> cam2 transform from camera-in-world poses."""
    return np.linalg.inv(pose2_wc) @ pose1_wc


def _num_frames(seq) -> int:
    return seq.num_frames() if hasattr(seq, "num_frames") else len(seq)


def _frame_pairs(seq, spacing: int, num_pairs: int):
    max_start = _num_frames(seq) - spacing
    if max_start <= 0:
        return []
    starts = np.linspace(0, max_start - 1, min(num_pairs, max_start)).astype(int)
    return [(int(s), int(s + spacing)) for s in starts]


def _scaled_K(cam: PinholeCamera) -> np.ndarray:
    return np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=np.float64)


def _gt_warp(fi: Dict, fj: Dict, kpts1: np.ndarray, K: np.ndarray):
    """Frame-i keypoints warped into frame j: depth reprojection when the
    frame has a depth map, the rotation-only homography otherwise."""
    T_12 = _relative_cam_transform(fi["pose_wc"], fj["pose_wc"])
    if "depth" in fi:
        return metrics.reproject_with_depth(kpts1, fi["depth"], T_12, K)
    H = metrics.rotation_homography_np(K, T_12)
    warped = metrics.warp_points(H, np.asarray(kpts1, dtype=np.float64))
    return warped, np.ones(len(warped), dtype=bool)


# ---------------------------------------------------------------------------
# The four tests
# ---------------------------------------------------------------------------


def run_repeatability_test(seq, adapter: FrontendAdapter, spacing: int = 1, num_pairs: int = 20,
                           threshold_px: float = 3.0) -> Dict:
    """Repeatability over frame pairs ``spacing`` apart; target >= 60%."""
    pairs = _frame_pairs(seq, spacing, num_pairs)
    K = _scaled_K(seq.cam)
    results = []
    for i, j in pairs:
        fi, fj = seq.frame(i), seq.frame(j)
        feats = adapter.extract(np.stack([fi["rgb"], fj["rgb"]]))
        k1 = feats["xy"][0][feats["valid"][0]]
        k2 = feats["xy"][1][feats["valid"][1]]
        warped, visible = _gt_warp(fi, fj, k1, K)
        inb = (
            visible
            & (warped[:, 0] >= 0) & (warped[:, 0] < seq.cam.width)
            & (warped[:, 1] >= 0) & (warped[:, 1] < seq.cam.height)
        )
        results.append(metrics.nn_agreement(warped[inb], k2, threshold_px))
    reps = [r["repeatability"] for r in results]
    return {
        "test": "repeatability",
        "spacing": spacing,
        "num_pairs": len(results),
        "mean_repeatability": float(np.mean(reps)) if reps else 0.0,
        "std_repeatability": float(np.std(reps)) if reps else 0.0,
        "median_repeatability": float(np.median(reps)) if reps else 0.0,
        "target": metrics.DEFAULT_TARGETS["repeatability"],
        "passed": bool(reps and np.mean(reps) >= metrics.DEFAULT_TARGETS["repeatability"]),
        "per_pair": results,
    }


def run_descriptor_quality_test(seq, adapter: FrontendAdapter, spacing: int = 1, num_pairs: int = 20,
                                threshold_px: float = 3.0) -> Dict:
    """Precision, recall and inlier ratio of the matches against the
    ground-truth warp; targets inlier >= 80%, precision >= 70%."""
    pairs = _frame_pairs(seq, spacing, num_pairs)
    K = _scaled_K(seq.cam)
    per_pair = []
    for i, j in pairs:
        fi, fj = seq.frame(i), seq.frame(j)
        feats = adapter.extract(np.stack([fi["rgb"], fj["rgb"]]))
        k1, k2 = feats["xy"][0], feats["xy"][1]
        warped, visible = _gt_warp(fi, fj, k1, K)
        pred = adapter.match(feats, 0, 1)
        gt = metrics.gt_matches_from_warp(warped, visible, k2, threshold_px)
        per_pair.append(metrics.match_quality_from_warp(pred, gt, warped, k2, threshold_px))
    agg = {
        k: float(np.mean([p[k] for p in per_pair])) if per_pair else 0.0
        for k in ("precision", "recall", "f1", "inlier_ratio", "num_matches")
    }
    return {
        "test": "descriptor_quality",
        "spacing": spacing,
        "num_pairs": len(per_pair),
        **agg,
        "targets": {
            "inlier_ratio": metrics.DEFAULT_TARGETS["inlier_ratio"],
            "precision": metrics.DEFAULT_TARGETS["precision"],
        },
        "passed": bool(
            per_pair
            and agg["inlier_ratio"] >= metrics.DEFAULT_TARGETS["inlier_ratio"]
            and agg["precision"] >= metrics.DEFAULT_TARGETS["precision"]
        ),
        "per_pair": per_pair,
    }


def run_tracking_test(seq, adapter: FrontendAdapter, spacing: int = 1, max_frames: int = 100,
                      min_matches: int = 50) -> Dict:
    """Share of sequential steps with at least ``min_matches`` matches;
    target >= 90%."""
    idxs = list(range(0, min(_num_frames(seq), max_frames * spacing), spacing))
    rgb = np.stack([seq.frame(i)["rgb"] for i in idxs])
    feats = adapter.extract(rgb)
    counts = [len(adapter.match(feats, t, t + 1)) for t in range(len(idxs) - 1)]
    result = metrics.tracking_success(counts, min_matches)
    return {
        "test": "tracking",
        "spacing": spacing,
        **result,
        "target": metrics.DEFAULT_TARGETS["tracking_success"],
        "passed": bool(result["success_rate"] >= metrics.DEFAULT_TARGETS["tracking_success"]),
    }


def run_performance_test(seq, adapter: FrontendAdapter, batch: int = 1) -> Dict:
    """Per-stage latency of the adapter's stages on ``batch`` frames and
    the fps they add up to; target >= 20 FPS."""
    rgb = np.stack([seq.frame(i % len(seq))["rgb"] for i in range(batch)])
    if adapter.stages is None:
        return {"test": "performance", "skipped": "adapter has no stage harness"}
    stage_results = metrics.benchmark_stages(adapter.stages(rgb))
    fps = stage_results["total"]["fps"] * batch
    return {
        "test": "performance",
        "batch": batch,
        "stages": stage_results,
        "fps": fps,
        "target": metrics.DEFAULT_TARGETS["fps"],
        "passed": bool(fps >= metrics.DEFAULT_TARGETS["fps"]),
    }


def check_sequence_overlap(test_sequences: Sequence[str], train_sequences: Sequence[str]) -> List[str]:
    """Test sequences that were also trained on (their results are inflated)."""
    return sorted(set(test_sequences) & set(train_sequences))


def run_all(seq, adapter: FrontendAdapter, difficulty: str = "normal", with_performance: bool = True) -> Dict:
    """Every test at the preset of ``difficulty`` over one sequence."""
    preset = DIFFICULTY_PRESETS[difficulty]
    results: Dict = {"difficulty": difficulty, "frontend": adapter.name}
    results["repeatability"] = [
        run_repeatability_test(seq, adapter, spacing=s, num_pairs=preset["num_pairs"])
        for s in preset["spacings"]
    ]
    results["descriptor_quality"] = run_descriptor_quality_test(seq, adapter, num_pairs=preset["num_pairs"])
    results["tracking"] = [
        run_tracking_test(seq, adapter, spacing=s, min_matches=preset["min_matches"])
        for s in preset["spacings"]
    ]
    if with_performance:
        results["performance"] = run_performance_test(seq, adapter)
    results["all_passed"] = all(
        r["passed"]
        for r in (
            results["repeatability"]
            + [results["descriptor_quality"]]
            + results["tracking"]
            + ([results["performance"]] if with_performance else [])
        )
        if "passed" in r
    )
    return results
