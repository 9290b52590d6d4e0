"""Full-sequence RGB-D SLAM with fixed-shape ring-buffer state (port of
``slam/system.py``).

Map state: M landmark slots (position, descriptor, validity, weight) and
a W-slot keyframe window (pose plus a dense (W, M) observation grid for
window BA). Per frame: descriptor matching of the frame's keypoints
against every live landmark (Hamming for packed ORB words, cosine for
learned float descriptors), RANSAC + Gauss-Newton PnP against the map, and, when
tracking support drops, a keyframe: unmatched keypoints become new
landmarks, the observation row is written and the window is bundle
adjusted. The JAX ``lax.scan`` over frames is a Python loop here and its
``lax.cond`` a real branch.

Recorded (``utils/profiling.py``): ``run_slam`` is the root call
``slam.run``, ``bootstrap_map`` and ``run_slam_steps`` are ``slam.bootstrap``
and ``slam.steps`` (roots themselves when called alone, as live tracking
calls them); inside, the spans ``slam.match``, ``slam.ransac`` and
``slam.refine`` (``pnp.ransac_pose``), ``slam.map`` and ``slam.ba``, a
``sync`` at each read of a device value on the host and each blocking copy
from it (``lie.make_pose``'s constant row among them), and the counter
``keyframes`` (tracked frames that became keyframes; the bootstrap frame
is not counted); on the card also ``refine_kernels``, one launch of
``slam.refine``'s kernel a tracked frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import PinholeCamera, backproject
from ..ops import matching
from ..utils import profiling
from . import ba, pnp
from .tracking import FrameFeatures


class MapState(NamedTuple):
    """Fixed-shape SLAM map. M landmark slots, W keyframe slots."""

    positions: torch.Tensor  # (M, 3) world
    descriptors: torch.Tensor  # (M, D) int64 packed ORB words or f32 learned
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
    """The JAX package's ``SlamConfig`` fields that the ORB and learned
    paths read."""

    num_landmarks: int = 2048
    window_size: int = 5
    num_hypotheses: int = 64
    min_inliers: int = 15
    keyframe_min_inlier_ratio: float = 0.4
    keyframe_min_gap: int = 2
    match_max_distance: float = 64.0  # Hamming gate (packed ORB descriptors)
    match_min_cosine: float = 0.6  # cosine gate (learned float descriptors)
    min_landmark_weight: float = 0.25
    ba_iters: int = 4
    depth_weight: float = 30.0
    # Landmark birth filter (``_refine_landmarks``): each of a landmark's
    # first ``lm_refine_cap`` inlier sightings pulls it to the online mean,
    # then it freezes. Off by default, as in the JAX package, whose
    # measurements found it no help at Kinect depth noise.
    lm_refine_cap: int = 0


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
    with profiling.sync("map.scatter", 2):  # two boolean-mask reads
        out[slots[keep]] = src[keep].to(dst.dtype)
    return out


def match_features(desc1, desc2, valid1, valid2, cfg: SlamConfig) -> matching.Matches:
    """Descriptor matching dispatched on dtype: packed ORB words (integer
    dtype; the port keeps them as int64) use Hamming with the distance
    gate, learned float descriptors cosine similarity with the
    ``match_min_cosine`` gate and no ratio test."""
    if not torch.is_floating_point(desc1):
        return matching.match_hamming(desc1, desc2, valid1, valid2, max_distance=cfg.match_max_distance)
    return matching.match_cosine(
        desc1, desc2, valid1, valid2, ratio=None, min_similarity=cfg.match_min_cosine
    )


def init_map(cfg: SlamConfig, device, desc_dim: int = 8, desc_dtype=torch.int64,
             dtype=torch.float32) -> MapState:
    M, W = cfg.num_landmarks, cfg.window_size
    kw = dict(dtype=dtype, device=device)
    return MapState(
        positions=torch.zeros((M, 3), **kw),
        descriptors=torch.zeros((M, desc_dim), dtype=desc_dtype, device=device),
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
    with profiling.sync("map.num_new"):
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


def _refine_landmarks(
    state: MapState,
    T_wc: torch.Tensor,
    pts_cam_meas: torch.Tensor,
    lm_idx: torch.Tensor,
    upd_mask: torch.Tensor,
    cfg: SlamConfig,
) -> MapState:
    """Online-mean landmark position filter for one tracked frame: each
    selected sighting (camera-frame point, moved to the world by ``T_wc``)
    pulls its landmark with gain 1/(count+1) while count < cap, then the
    gain is 0 and the position frozen. ``lm_idx`` is one-to-one on
    ``upd_mask`` (mutual nearest-neighbour matches)."""
    M = state.positions.shape[0]
    obs_world = lie.transform_points(T_wc, pts_cam_meas)  # (N, 3)
    count = state.lm_obs[lm_idx]
    alpha = torch.where(count < float(cfg.lm_refine_cap), 1.0 / (count + 1.0), torch.zeros_like(count))
    blended = state.positions[lm_idx] * (1.0 - alpha[:, None]) + obs_world * alpha[:, None]
    slots = torch.where(upd_mask, lm_idx, torch.full_like(lm_idx, M))
    return state._replace(
        positions=_scatter(state.positions, slots, blended),
        lm_obs=_scatter(state.lm_obs, slots, count + 1.0),
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

    with profiling.sync("map.kf_used"):  # a Python scalar is copied from the host
        kf_used = put(state.kf_used, True)
    return state._replace(
        kf_poses=put(state.kf_poses, T_cw),
        kf_obs=put(state.kf_obs, obs_row),
        kf_obs_depth=put(state.kf_obs_depth, depth_row),
        kf_valid=put(state.kf_valid, valid_row),
        kf_conf=put(state.kf_conf, conf_row),
        kf_used=kf_used,
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
    with profiling.span("slam.bootstrap", frames=1):
        dev = first.xy.device
        state = init_map(cfg, dev, desc_dim=first.desc.shape[-1], desc_dtype=first.desc.dtype)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        insert_mask = first.valid & (first.sem_weight >= cfg.min_landmark_weight)
        with profiling.span("slam.map"):
            state = _insert_landmarks(state, eye, first, insert_mask, first.sem_weight, cam)
            lm_idx0 = (torch.cumsum(insert_mask.to(torch.int64), 0) - 1) % cfg.num_landmarks
            return _write_keyframe(state, eye, first, lm_idx0, insert_mask, first.sem_weight)


def frame(features: FrameFeatures, i: int) -> FrameFeatures:
    """Frame ``i`` of batched features."""
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
    with profiling.span("slam.match"):
        m = match_features(feats.desc, state.descriptors, feats.valid, state.lm_valid, cfg)
    lm_idx, matched = m.idx2, m.valid
    pts_world = state.positions[lm_idx]
    pts_cam_meas = backproject(feats.xy, feats.depth, cam)
    weights = state.lm_weight[lm_idx] * feats.sem_weight
    result = pnp.ransac_pose(u, pts_world, pts_cam_meas, feats.xy, cam, matched, weights=weights)
    ok = result.num_inliers >= cfg.min_inliers
    T_cw = torch.where(ok, result.pose, lie.pose_inverse(T_prev_wc))
    T_wc = lie.pose_inverse(T_cw)
    if cfg.lm_refine_cap > 0:
        upd_mask = (matched & result.inlier_mask & ok & (feats.depth > 0.05)
                    & (feats.sem_weight >= cfg.min_landmark_weight))
        state = _refine_landmarks(state, T_wc, pts_cam_meas, lm_idx, upd_mask, cfg)

    n_valid = torch.clamp(torch.sum(feats.valid), min=1)
    inlier_ratio = result.num_inliers / n_valid
    with profiling.sync("step.need_kf"):
        need_kf = bool(
            ok & (inlier_ratio < cfg.keyframe_min_inlier_ratio) & (since >= cfg.keyframe_min_gap)
        )
    if need_kf:
        profiling.count("keyframes")
        with profiling.span("slam.map"):
            new_mask = feats.valid & ~matched & (feats.sem_weight >= cfg.min_landmark_weight)
            new_slots = _new_slots(state, new_mask)
            state = _insert_landmarks(state, T_wc, feats, new_mask, feats.sem_weight, cam)
            all_idx = torch.where(new_mask, new_slots, lm_idx)
            obs_mask = (matched & result.inlier_mask) | new_mask
            state = _write_keyframe(state, T_cw, feats, all_idx, obs_mask, feats.sem_weight)
        with profiling.span("slam.ba"):
            state = _run_local_ba(state, cam, cfg)
    since = 0 if need_kf else since + 1
    return state, T_wc, since, result.num_inliers, m.count(), need_kf


def run_slam_steps(
    uniforms: torch.Tensor,
    features: FrameFeatures,
    cam: PinholeCamera,
    cfg: SlamConfig,
    state: MapState,
    T_prev_wc: torch.Tensor,
    since: int,
):
    """Continue SLAM over ``features`` (F frames, no bootstrap frame) from
    an existing map: the resumable core of :func:`run_slam`, as the JAX
    package's ``run_slam_steps``. ``uniforms`` (F, num_hypotheses, 3)
    holds each frame's RANSAC draws; ``since`` counts frames since the
    last keyframe. Returns ((state, T_last_wc, since), SlamOutput rows
    for these F frames); chunked callers (``slam.online``) carry the
    triple across calls."""
    F = features.xy.shape[0]
    with profiling.span("slam.steps", frames=F):
        poses, n_inl, n_match, is_kf = [], [], [], []
        for f in range(F):
            state, T_prev_wc, since, inl, nm, kf = slam_step(
                uniforms[f], frame(features, f), cam, cfg, state, T_prev_wc, since
            )
            poses.append(T_prev_wc)
            n_inl.append(inl)
            n_match.append(nm)
            is_kf.append(kf)
        dev = features.xy.device
        empty = torch.zeros((0,), dtype=torch.int64, device=dev)
        with profiling.sync("steps.is_keyframe"):  # a blocking copy from the host
            is_keyframe = torch.tensor(is_kf, dtype=torch.bool, device=dev)
        out = SlamOutput(
            poses_wc=torch.stack(poses) if poses else torch.zeros((0, 4, 4), device=dev),
            num_inliers=torch.stack(n_inl) if n_inl else empty,
            num_matches=torch.stack(n_match) if n_match else empty,
            is_keyframe=is_keyframe,
        )
        return (state, T_prev_wc, since), out


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
    with profiling.span("slam.run", frames=F):
        dev = features.xy.device
        if isinstance(uniforms, torch.Generator):
            uniforms = torch.rand(
                (F, cfg.num_hypotheses, 3), generator=uniforms, device=uniforms.device
            ).to(dev)
        state = bootstrap_map(frame(features, 0), cam, cfg)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        # The bootstrap frame is a keyframe: the gap counter starts at zero.
        _, out = run_slam_steps(uniforms[1:], FrameFeatures(*[x[1:] for x in features]), cam, cfg,
                                state, eye, 0)
        zero = torch.zeros((1,), dtype=torch.int64, device=dev)
        return SlamOutput(
            poses_wc=torch.cat([eye[None], out.poses_wc]),
            num_inliers=torch.cat([zero, out.num_inliers]),
            num_matches=torch.cat([zero, out.num_matches]),
            is_keyframe=torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), out.is_keyframe]),
        )


def refine_active_map(state: MapState, cam: PinholeCamera, cfg: SlamConfig,
                      ba_iters: int = 8) -> MapState:
    """Post-loop refinement of the active map (the JAX package's
    ``refine_active_map``): each landmark observed in the window is
    re-triangulated as the confidence-weighted mean of its keyframe
    observations' backprojections under the (corrected) window poses,
    then window BA runs with ``ba_iters`` iterations. Landmarks with no
    live window observation keep their positions."""
    obs_ok = (
        state.kf_valid
        & state.kf_used[:, None]
        & state.lm_valid[None, :]
        & (state.kf_obs_depth > 0.05)
    )
    pts_cam = backproject(state.kf_obs, state.kf_obs_depth, cam)  # (W, M, 3)
    pts_world = lie.transform_points(lie.pose_inverse(state.kf_poses), pts_cam)  # (W, M, 3)
    w = (obs_ok.to(pts_world.dtype) * state.kf_conf)[..., None]
    total = torch.sum(w, dim=0)
    tri = torch.sum(w * pts_world, dim=0) / torch.clamp(total, min=1e-9)
    state = state._replace(positions=torch.where(total > 0, tri, state.positions))
    return _run_local_ba(state, cam, cfg._replace(ba_iters=ba_iters))
