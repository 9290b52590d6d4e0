"""Online (streaming) SLAM with loop closure between chunks (port of
``slam/online.py``).

Tracking and mapping run over chunks of frames (``system.run_slam_steps``,
carrying the map, the last pose and the keyframe gap across chunks).
Between chunks the chunk's new keyframes enter a persistent
``bow.BowIndex`` (vocabulary trained once, signatures computed once) and
one incremental closing pass runs (``loop_closing``). An accepted loop
rigidly re-anchors the active map by the correction of the most recent
pose, then ``system.refine_active_map`` re-triangulates the landmarks
against the corrected window and runs a deeper BA pass.

With loop closure off the output equals ``system.run_slam`` bit for bit:
the chunks run the same per-frame steps with the same uniforms. The JAX
package pads its tail chunk with empty frames to reuse one compiled
program and drops their rows; the port runs the tail chunk as it is,
which gives the same outputs (an empty frame tracks nothing and changes
no map state).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.camera import PinholeCamera
from ..core.device import synchronize
from . import bow, loop_closing, system
from .system import MapState, SlamConfig, SlamOutput
from .tracking import FrameFeatures


def _apply_correction(state: MapState, T_prev_wc: torch.Tensor,
                      delta_wc) -> Tuple[MapState, torch.Tensor]:
    """Rigidly move the active map by a world-frame correction ``delta``:
    world points x' = delta x, camera-in-world poses T_wc' = delta T_wc,
    world->camera keyframe poses T_cw' = T_cw delta^{-1} (f32)."""
    delta = torch.tensor(np.asarray(delta_wc), dtype=torch.float32).to(state.positions.device)
    R, t = delta[:3, :3], delta[:3, 3]
    positions = state.positions @ R.T + t
    kf_poses = state.kf_poses @ torch.linalg.inv(delta)[None]
    return state._replace(positions=positions, kf_poses=kf_poses), delta @ T_prev_wc


def _closing_pass(index, features, cam, cfg, state, T_prev, poses, is_kf, edges, accepted, scored,
                  min_score, min_frame_gap, min_inliers, max_loops_per_pass):
    """One incremental loop-closing pass over the keyframes indexed since
    ``scored``; applies an accepted correction to the active map (rigid
    re-anchor, then ``system.refine_active_map``). Extends ``edges`` and
    ``accepted`` in place; returns (state, T_prev, poses, scored)."""
    num_new = len(index.frame_ids) - scored
    hist_poses = np.stack(poses)
    corrected, loops, new_edges = loop_closing.close_loops_incremental(
        index, hist_poses, features, np.asarray(is_kf, bool), num_new, cam, prev_edges=edges,
        min_score=min_score, min_frame_gap=min_frame_gap, min_inliers=min_inliers,
        max_loops=max_loops_per_pass,
    )
    scored = len(index.frame_ids)
    if loops:
        edges.extend(new_edges)
        delta = corrected[-1] @ np.linalg.inv(hist_poses[-1])
        state, T_prev = _apply_correction(state, T_prev, delta)
        state = system.refine_active_map(state, cam, cfg)
        poses = list(corrected)
        accepted.extend(loops)
    return state, T_prev, poses, scored


def run_slam_online(
    uniforms: torch.Tensor,
    features: FrameFeatures,
    cam: PinholeCamera,
    cfg: SlamConfig = SlamConfig(),
    chunk_size: int = 32,
    enable_loop_closure: bool = True,
    min_score: float = 0.35,
    min_frame_gap: int = 30,
    min_inliers: int = 25,
    max_loops_per_pass: int = 5,
    timings: Optional[List[dict]] = None,
) -> Tuple[SlamOutput, List[Tuple[int, int, float]]]:
    """Streaming SLAM over ``features`` with loop closure between chunks.

    ``uniforms`` (F, num_hypotheses, 3): the per-frame RANSAC draws, row f
    for frame f (``core.prng.slam_uniforms`` gives the JAX package's for a
    seed). If ``timings`` is a list, one dict per chunk is appended:
    ``{start, frames, slam_s, closure_s, keyframes_indexed,
    keyframes_total}`` (host clock, the device synchronised).

    Returns (SlamOutput over all F frames, accepted loops
    [(frame_i, frame_j, score)]).
    """
    F = features.xy.shape[0]
    dev = features.xy.device
    state = system.bootstrap_map(system.frame(features, 0), cam, cfg)
    T_prev = torch.eye(4, dtype=torch.float32, device=dev)
    since_kf = 0  # the bootstrap frame is a keyframe

    poses = [np.eye(4, dtype=np.float64)]
    n_inl, n_match, is_kf = [0], [0], [True]
    accepted: List[Tuple[int, int, float]] = []
    index = bow.BowIndex()
    index.add_keyframe(features.desc[0], features.valid[0], 0)
    edges: List = []  # accepted pose-graph edges, re-used every pass
    scored = 0  # indexed keyframes already scored against the history

    pos = 1
    while pos < F:
        t_chunk = time.perf_counter()
        end = min(pos + chunk_size, F)
        chunk = FrameFeatures(*[x[pos:end] for x in features])
        (state, T_prev, since_kf), out = system.run_slam_steps(
            uniforms[pos:end], chunk, cam, cfg, state, T_prev, since_kf)
        poses.extend(out.poses_wc.cpu().numpy().astype(np.float64))
        n_inl.extend(out.num_inliers.tolist())
        n_match.extend(out.num_matches.tolist())
        is_kf.extend(out.is_keyframe.tolist())
        t_slam = time.perf_counter()

        kf_new = 0
        if enable_loop_closure:
            for f in range(pos, end):
                if is_kf[f]:
                    index.add_keyframe(features.desc[f], features.valid[f], f)
                    kf_new += 1
            state, T_prev, poses, scored = _closing_pass(
                index, features, cam, cfg, state, T_prev, poses, is_kf, edges, accepted, scored,
                min_score, min_frame_gap, min_inliers, max_loops_per_pass)
        if timings is not None:
            synchronize(dev)
            timings.append({
                "start": pos,
                "frames": end - pos,
                "slam_s": round(t_slam - t_chunk, 4),
                "closure_s": round(time.perf_counter() - t_slam, 4),
                "keyframes_indexed": kf_new,
                "keyframes_total": len(index.frame_ids),
            })
        pos = end

    if enable_loop_closure and index.vocab is None and index.force_train():
        # The sequence ended before the vocabulary's training corpus
        # accumulated: train on what there is and run one last pass.
        state, T_prev, poses, scored = _closing_pass(
            index, features, cam, cfg, state, T_prev, poses, is_kf, edges, accepted, scored,
            min_score, min_frame_gap, min_inliers, max_loops_per_pass)

    out = SlamOutput(
        poses_wc=torch.tensor(np.stack(poses), dtype=torch.float32, device=dev),
        num_inliers=torch.tensor(n_inl, dtype=torch.int64, device=dev),
        num_matches=torch.tensor(n_match, dtype=torch.int64, device=dev),
        is_keyframe=torch.tensor(is_kf, dtype=torch.bool, device=dev),
    )
    return out, accepted
