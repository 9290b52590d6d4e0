"""Full-sequence RGB-D SLAM with fixed-shape ring-buffer state (port of
``slam/system.py``).

Map state: M landmark slots (position, descriptor, validity, weight) and
a W-slot keyframe window (pose plus a dense (W, M) observation grid for
window BA). Per frame: Hamming matching of the frame's keypoints against
every live landmark, RANSAC + Gauss-Newton PnP against the map, and, when
tracking support drops, a keyframe: unmatched keypoints become new
landmarks, the observation row is written and the window is bundle
adjusted. The JAX ``lax.scan`` over frames is a Python loop here and its
``lax.cond`` a real branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import PinholeCamera, backproject
from ..ops import matching
from . import ba, pnp
from .tracking import FrameFeatures


class MapState(NamedTuple):
    """Fixed-shape SLAM map. M landmark slots, W keyframe slots."""

    positions: torch.Tensor  # (M, 3) world
    descriptors: torch.Tensor  # (M, 8) int64 packed ORB words
    lm_valid: torch.Tensor  # (M,) bool
    lm_weight: torch.Tensor  # (M,) semantic/confidence BA weight
    lm_obs: torch.Tensor  # (M,) observation count
    write_ptr: int  # landmark ring pointer
    kf_poses: torch.Tensor  # (W, 4, 4) world->camera
    kf_obs: torch.Tensor  # (W, M, 2)
    kf_obs_depth: torch.Tensor  # (W, M)
    kf_valid: torch.Tensor  # (W, M) bool
    kf_conf: torch.Tensor  # (W, M)
    kf_used: torch.Tensor  # (W,) bool
    kf_ptr: int  # keyframe ring pointer


class SlamConfig(NamedTuple):
    """The JAX package's ``SlamConfig`` fields that the ORB path reads."""

    num_landmarks: int = 2048
    window_size: int = 5
    num_hypotheses: int = 64
    min_inliers: int = 15
    keyframe_min_inlier_ratio: float = 0.4
    keyframe_min_gap: int = 2
    match_max_distance: float = 64.0
    min_landmark_weight: float = 0.25
    ba_iters: int = 4
    depth_weight: float = 30.0


class SlamOutput(NamedTuple):
    poses_wc: torch.Tensor  # (F, 4, 4)
    num_inliers: torch.Tensor  # (F,)
    num_matches: torch.Tensor  # (F,)
    is_keyframe: torch.Tensor  # (F,) bool


def _scatter(dst: torch.Tensor, slots: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.at[slots].set(src)`` where slot ``len(dst)`` means "drop";
    of several writes to one slot the last (highest source index) wins,
    on every device."""
    M = dst.shape[0]
    order = torch.arange(slots.shape[0], device=slots.device)
    winner = torch.full((M + 1,), -1, dtype=order.dtype, device=slots.device)
    winner.scatter_reduce_(0, slots, order, reduce="amax")
    keep = (slots < M) & (winner[slots] == order)
    out = dst.clone()
    out[slots[keep]] = src[keep].to(dst.dtype)
    return out


def init_map(cfg: SlamConfig, device, desc_dim: int = 8, dtype=torch.float32) -> MapState:
    M, W = cfg.num_landmarks, cfg.window_size
    kw = dict(dtype=dtype, device=device)
    return MapState(
        positions=torch.zeros((M, 3), **kw),
        descriptors=torch.zeros((M, desc_dim), dtype=torch.int64, device=device),
        lm_valid=torch.zeros((M,), dtype=torch.bool, device=device),
        lm_weight=torch.ones((M,), **kw),
        lm_obs=torch.zeros((M,), **kw),
        write_ptr=0,
        kf_poses=torch.eye(4, **kw).repeat(W, 1, 1),
        kf_obs=torch.zeros((W, M, 2), **kw),
        kf_obs_depth=torch.zeros((W, M), **kw),
        kf_valid=torch.zeros((W, M), dtype=torch.bool, device=device),
        kf_conf=torch.ones((W, M), **kw),
        kf_used=torch.zeros((W,), dtype=torch.bool, device=device),
        kf_ptr=0,
    )


def _new_slots(state: MapState, new_mask: torch.Tensor) -> torch.Tensor:
    """Ring slot of each selected keypoint (ptr + rank), M for the rest."""
    M = state.positions.shape[0]
    ranks = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    return torch.where(new_mask, (state.write_ptr + ranks) % M, torch.full_like(ranks, M))


def _insert_landmarks(
    state: MapState,
    T_wc: torch.Tensor,
    feats: FrameFeatures,
    new_mask: torch.Tensor,
    weights: torch.Tensor,
    cam: PinholeCamera,
) -> MapState:
    """Ring-buffer insert of the keypoints in ``new_mask`` as landmarks."""
    M = state.positions.shape[0]
    slots = _new_slots(state, new_mask)
    num_new = int(new_mask.sum())
    pts_world = lie.transform_points(T_wc, backproject(feats.xy, feats.depth, cam))
    ones = torch.ones_like(weights)
    reused = _scatter(torch.zeros_like(state.lm_valid), slots, new_mask)
    return state._replace(
        positions=_scatter(state.positions, slots, pts_world),
        descriptors=_scatter(state.descriptors, slots, feats.desc),
        lm_valid=_scatter(state.lm_valid, slots, new_mask),
        lm_weight=_scatter(state.lm_weight, slots, weights),
        lm_obs=_scatter(state.lm_obs, slots, ones),
        kf_valid=state.kf_valid & ~reused[None, :],
        write_ptr=(state.write_ptr + num_new) % M,
    )


def _write_keyframe(
    state: MapState,
    T_cw: torch.Tensor,
    feats: FrameFeatures,
    lm_idx: torch.Tensor,
    matched: torch.Tensor,
    weights: torch.Tensor,
) -> MapState:
    """Record a keyframe row: observations of the matched landmarks."""
    M = state.positions.shape[0]
    k = state.kf_ptr
    slots = torch.where(matched, lm_idx, torch.full_like(lm_idx, M))
    obs_row = _scatter(torch.zeros_like(state.kf_obs[0]), slots, feats.xy)
    depth_row = _scatter(torch.zeros_like(state.kf_obs_depth[0]), slots, feats.depth)
    valid_row = _scatter(torch.zeros_like(state.kf_valid[0]), slots, matched)
    conf_row = _scatter(torch.ones_like(state.kf_conf[0]), slots, weights)

    def put(buf, row):
        buf = buf.clone()
        buf[k] = row
        return buf

    return state._replace(
        kf_poses=put(state.kf_poses, T_cw),
        kf_obs=put(state.kf_obs, obs_row),
        kf_obs_depth=put(state.kf_obs_depth, depth_row),
        kf_valid=put(state.kf_valid, valid_row),
        kf_conf=put(state.kf_conf, conf_row),
        kf_used=put(state.kf_used, True),
        kf_ptr=(k + 1) % state.kf_used.shape[0],
    )


def _run_local_ba(state: MapState, cam: PinholeCamera, cfg: SlamConfig) -> MapState:
    """Window BA over the keyframe ring; confidence = kf_conf x lm_weight."""
    problem = ba.BAProblem(
        poses=state.kf_poses,
        points=state.positions,
        observations=state.kf_obs,
        valid=state.kf_valid & state.kf_used[:, None] & state.lm_valid[None, :],
        confidence=state.kf_conf * state.lm_weight[None, :],
        obs_depth=state.kf_obs_depth,
    )
    result = ba.bundle_adjust(problem, cam, num_iters=cfg.ba_iters, depth_weight=cfg.depth_weight)
    return state._replace(kf_poses=result.poses, positions=result.points)


def bootstrap_map(first: FrameFeatures, cam: PinholeCamera, cfg: SlamConfig) -> MapState:
    """First frame defines the world: its valid keypoints become landmarks
    and keyframe 0 (at identity)."""
    dev = first.xy.device
    state = init_map(cfg, dev, desc_dim=first.desc.shape[-1])
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    insert_mask = first.valid & (first.sem_weight >= cfg.min_landmark_weight)
    state = _insert_landmarks(state, eye, first, insert_mask, first.sem_weight, cam)
    lm_idx0 = (torch.cumsum(insert_mask.to(torch.int64), 0) - 1) % cfg.num_landmarks
    return _write_keyframe(state, eye, first, lm_idx0, insert_mask, first.sem_weight)


def _frame(features: FrameFeatures, i: int) -> FrameFeatures:
    return FrameFeatures(*[x[i] for x in features])


def slam_step(
    u: torch.Tensor,
    feats: FrameFeatures,
    cam: PinholeCamera,
    cfg: SlamConfig,
    state: MapState,
    T_prev_wc: torch.Tensor,
    since: int,
):
    """One tracked frame. ``u`` (num_hypotheses, 3) RANSAC uniforms.
    Returns (state, T_wc, since, num_inliers, num_matches, is_keyframe)."""
    m = matching.match_hamming(
        feats.desc, state.descriptors, feats.valid, state.lm_valid,
        max_distance=cfg.match_max_distance,
    )
    lm_idx, matched = m.idx2, m.valid
    pts_world = state.positions[lm_idx]
    pts_cam_meas = backproject(feats.xy, feats.depth, cam)
    weights = state.lm_weight[lm_idx] * feats.sem_weight
    result = pnp.ransac_pose(u, pts_world, pts_cam_meas, feats.xy, cam, matched, weights=weights)
    ok = result.num_inliers >= cfg.min_inliers
    T_cw = torch.where(ok, result.pose, lie.pose_inverse(T_prev_wc))
    T_wc = lie.pose_inverse(T_cw)

    n_valid = torch.clamp(torch.sum(feats.valid), min=1)
    inlier_ratio = result.num_inliers / n_valid
    need_kf = bool(
        ok & (inlier_ratio < cfg.keyframe_min_inlier_ratio) & (since >= cfg.keyframe_min_gap)
    )
    if need_kf:
        new_mask = feats.valid & ~matched & (feats.sem_weight >= cfg.min_landmark_weight)
        new_slots = _new_slots(state, new_mask)
        state = _insert_landmarks(state, T_wc, feats, new_mask, feats.sem_weight, cam)
        all_idx = torch.where(new_mask, new_slots, lm_idx)
        obs_mask = (matched & result.inlier_mask) | new_mask
        state = _write_keyframe(state, T_cw, feats, all_idx, obs_mask, feats.sem_weight)
        state = _run_local_ba(state, cam, cfg)
    since = 0 if need_kf else since + 1
    return state, T_wc, since, result.num_inliers, m.count(), need_kf


def run_slam(
    uniforms: torch.Tensor | torch.Generator,
    features: FrameFeatures,
    cam: PinholeCamera,
    cfg: SlamConfig = SlamConfig(),
) -> SlamOutput:
    """SLAM over a sequence of per-frame features (F leading axis).

    ``uniforms`` is either the RANSAC draws, (F, num_hypotheses, 3) in
    [0, 1) with row f used by frame f (row 0, the bootstrap frame, is
    unused), or a ``torch.Generator`` they are drawn from.
    """
    F = features.xy.shape[0]
    dev = features.xy.device
    if isinstance(uniforms, torch.Generator):
        uniforms = torch.rand(
            (F, cfg.num_hypotheses, 3), generator=uniforms, device=uniforms.device
        ).to(dev)
    state = bootstrap_map(_frame(features, 0), cam, cfg)
    T_wc = torch.eye(4, dtype=torch.float32, device=dev)
    since = 0
    poses, n_inl, n_match, is_kf = [T_wc], [torch.zeros((), dtype=torch.int64, device=dev)], [
        torch.zeros((), dtype=torch.int64, device=dev)
    ], [True]
    for f in range(1, F):
        state, T_wc, since, inl, nm, kf = slam_step(
            uniforms[f], _frame(features, f), cam, cfg, state, T_wc, since
        )
        poses.append(T_wc)
        n_inl.append(inl)
        n_match.append(nm)
        is_kf.append(kf)
    return SlamOutput(
        poses_wc=torch.stack(poses),
        num_inliers=torch.stack(n_inl),
        num_matches=torch.stack(n_match),
        is_keyframe=torch.tensor(is_kf, device=dev),
    )
