"""Loop closing over a SLAM run (port of ``slam/loop_closing.py``).

1. BoW place recognition over keyframes (``slam.bow``);
2. geometric verification and relative pose of each candidate by
   Hamming matching and RANSAC/Kabsch on backprojected keypoints
   (``slam.pnp``), under three gates;
3. pose-graph optimisation of the keyframe chain with the loop edges
   (``slam.posegraph``);
4. each frame moves rigidly with its nearest preceding keyframe.

The RANSAC draws are the JAX package's: ``PRNGKey(seed)``, split once
per verified candidate, ``uniform(sub, (128, 3))`` (``core/prng.py``).
The propagation is float64 numpy, as in JAX.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.camera import PinholeCamera, backproject
from ..ops import matching
from . import bow, pnp, posegraph, system
from .tracking import FrameFeatures

LOOP_HYPOTHESES = 128


def _loop_edge_pose(u: torch.Tensor, feats_i: FrameFeatures, feats_j: FrameFeatures,
                    cam: PinholeCamera):
    """Measured Z = T_i^{-1} T_j (maps cam-j points into cam-i) from the two
    frames' features, with RANSAC uniforms ``u`` (128, 3). Returns
    (Z (4, 4) float32 tensor, num_inliers, num_matches)."""
    m = matching.match_hamming(feats_j.desc, feats_i.desc, feats_j.valid, feats_i.valid,
                               max_distance=64.0)
    pts_j = backproject(feats_j.xy, feats_j.depth, cam)
    xy_i = feats_i.xy[m.idx2]
    d_i = feats_i.depth[m.idx2]
    pts_i = backproject(xy_i, d_i, cam)
    valid = m.valid & (d_i > 0.05)
    result = pnp.ransac_pose(u, pts_j, pts_i, xy_i, cam, valid)
    return result.pose, int(result.num_inliers), int(m.count())


def verify_candidates(
    candidates,
    features: FrameFeatures,
    cam: PinholeCamera,
    min_inliers: int,
    max_loops: int,
    seed: int = 0,
    poses_wc: np.ndarray | None = None,
    min_inlier_ratio: float = 0.35,
    max_correction_trans: float = 0.75,
    max_correction_rot_deg: float = 30.0,
    max_verify: int | None = None,
):
    """Geometric verification of BoW loop candidates. Returns
    (edges [(frame_i, frame_j, Z np (4, 4), weight)], accepted
    [(frame_i, frame_j, score)]). Gates: (1) at least ``min_inliers``
    RANSAC inliers; (2) inliers at least ``min_inlier_ratio`` of the
    matches (aliasing gives many matches with a small consistent subset);
    (3) with ``poses_wc``, the measured loop transform within
    ``max_correction_trans`` m and ``max_correction_rot_deg`` of the
    odometry's. At most ``max_verify`` candidates are verified (default
    max(3 max_loops, 12)) and ``max_loops`` accepted."""
    if max_verify is None:
        max_verify = max(3 * max_loops, 12)
    key = prng.PRNGKey(seed)
    dev = features.xy.device
    edges, accepted = [], []
    for fi, fj, score in candidates[:max_verify]:
        if len(accepted) >= max_loops:
            break
        key, sub = prng.split(key)
        u = torch.from_numpy(prng.uniform(sub, (LOOP_HYPOTHESES, 3))).to(dev)
        Z, inl, n_match = _loop_edge_pose(u, system.frame(features, fi), system.frame(features, fj),
                                          cam)
        if inl < min_inliers or inl < min_inlier_ratio * max(n_match, 1):
            continue
        Z = Z.cpu().numpy()
        if poses_wc is not None:
            Z_odo = np.linalg.inv(poses_wc[fi]) @ poses_wc[fj]
            delta = np.asarray(Z, np.float64) @ np.linalg.inv(Z_odo)
            dt = float(np.linalg.norm(delta[:3, 3]))
            cos = (np.trace(delta[:3, :3]) - 1.0) / 2.0
            dr = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
            if dt > max_correction_trans or dr > max_correction_rot_deg:
                continue
        edges.append((fi, fj, Z, 5.0))
        accepted.append((fi, fj, score))
    return edges, accepted


def _optimize_and_propagate(poses_wc: np.ndarray, kf_idx: np.ndarray, edges, device) -> np.ndarray:
    """Pose-graph optimise the keyframe chain with loop ``edges`` (keyframe
    positions), then move every frame rigidly with its nearest preceding
    keyframe (float64 numpy)."""
    kf_poses = torch.tensor(poses_wc[kf_idx], dtype=torch.float32, device=device)
    kf_opt = posegraph.close_loops(kf_poses, edges).cpu().numpy().astype(np.float64)
    corrections = np.einsum("kij,kjl->kil", kf_opt, np.linalg.inv(poses_wc[kf_idx]))
    owner = np.searchsorted(kf_idx, np.arange(len(poses_wc)), side="right") - 1
    owner = np.clip(owner, 0, len(kf_idx) - 1)
    return np.einsum("fij,fjl->fil", corrections[owner], poses_wc)


def _graph_edges(edges, kf_idx: np.ndarray):
    """(frame_i, frame_j, Z, w) -> (keyframe_i, keyframe_j, Z f32, w) for
    the edges whose two frames are keyframes."""
    kf_pos = {int(f): k for k, f in enumerate(kf_idx)}
    return [(kf_pos[fi], kf_pos[fj], np.asarray(Z, np.float32), w)
            for fi, fj, Z, w in edges if fi in kf_pos and fj in kf_pos]


def close_sequence_loops(
    poses_wc: np.ndarray,
    features: FrameFeatures,
    is_keyframe: np.ndarray,
    cam: PinholeCamera,
    vocab: torch.Tensor | None = None,
    min_score: float = 0.35,
    min_frame_gap: int = 30,
    min_inliers: int = 25,
    max_loops: int = 10,
    seed: int = 0,
    exclude=(),
) -> Tuple[np.ndarray, List[Tuple[int, int, float]]]:
    """Detect and close loops over a finished run: (corrected poses
    (F, 4, 4) float64, accepted loops [(frame_i, frame_j, score)]).
    Without ``vocab`` a k-medians vocabulary is trained on the keyframes'
    own descriptors. ``exclude``: (frame_i, frame_j[, score]) loops
    already closed, skipped as candidates."""
    poses_wc = np.asarray(poses_wc, dtype=np.float64)
    kf_idx = np.flatnonzero(np.asarray(is_keyframe))
    if len(kf_idx) < 3:
        return poses_wc, []
    if vocab is None:
        idx = torch.as_tensor(kf_idx, device=features.desc.device)
        corpus = features.desc[idx].reshape(-1, features.desc.shape[-1])
        corpus = corpus[features.valid[idx].reshape(-1)]
        num_words = int(min(1024, max(64, len(corpus) // 4)))
        vocab = bow.train_vocabulary(corpus, num_words=num_words)

    candidates = bow.detect_loops(features.desc, features.valid, kf_idx, vocab,
                                  min_score=min_score, min_frame_gap=min_frame_gap)
    done = {(int(e[0]), int(e[1])) for e in exclude}
    candidates = [c for c in candidates if (c[0], c[1]) not in done]
    candidates.sort(key=lambda t: -t[2])

    raw_edges, accepted = verify_candidates(candidates, features, cam, min_inliers, max_loops,
                                            seed=seed, poses_wc=poses_wc)
    if not raw_edges:
        return poses_wc, []
    corrected = _optimize_and_propagate(poses_wc, kf_idx, _graph_edges(raw_edges, kf_idx),
                                        features.xy.device)
    return corrected, accepted


def close_loops_incremental(
    index: bow.BowIndex,
    poses_wc: np.ndarray,
    features: FrameFeatures,
    is_keyframe: np.ndarray,
    num_new_keyframes: int,
    cam: PinholeCamera,
    prev_edges: list,
    min_score: float = 0.35,
    min_frame_gap: int = 30,
    min_inliers: int = 25,
    max_loops: int = 5,
    seed: int = 0,
):
    """One incremental loop-closing pass for online SLAM: the
    ``num_new_keyframes`` most recent keyframes of the persistent
    ``index`` are scored against the history, verified, and the pose
    graph is re-optimised over all accepted edges so far
    (``prev_edges`` + the new ones). Returns (corrected poses (F, 4, 4),
    newly accepted [(frame_i, frame_j, score)], new edges)."""
    poses_wc = np.asarray(poses_wc, dtype=np.float64)
    kf_idx = np.flatnonzero(np.asarray(is_keyframe))
    candidates = index.new_candidates(num_new_keyframes, min_score=min_score,
                                      min_frame_gap=min_frame_gap)
    new_edges, accepted = verify_candidates(candidates, features, cam, min_inliers, max_loops,
                                            seed=seed, poses_wc=poses_wc)
    if not new_edges:
        return poses_wc, [], []
    edges = _graph_edges(list(prev_edges) + new_edges, kf_idx)
    corrected = _optimize_and_propagate(poses_wc, kf_idx, edges, features.xy.device)
    return corrected, accepted, new_edges
