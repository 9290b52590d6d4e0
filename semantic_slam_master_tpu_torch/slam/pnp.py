"""Pose estimation: weighted Horn-Kabsch, robust Gauss-Newton PnP and a
fixed-budget RANSAC batched over hypotheses (port of ``slam/pnp.py``).

``ransac_pose`` takes its random draw as uniforms ``u`` (H, 3) in [0, 1)
and applies ``jax.random.choice``'s inverse-CDF formula to them, so fed
the uniforms JAX draws it picks the same samples.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import lie
from ..core.camera import PinholeCamera, project

_mm = lie.mm_small
_mv = lie.mv_small


def _inv4x4_sym(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a symmetric 4x4 by 2x2 block elimination."""

    def inv2(M):
        a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        det = torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) / det[..., None, None]

    P, Q = A[..., :2, :2], A[..., :2, 2:]
    S = A[..., 2:, 2:]
    P_inv = inv2(P)
    Sc = S - _mm(_mm(Q.transpose(-1, -2), P_inv), Q)
    Sc_inv = inv2(Sc)
    PiQ = _mm(P_inv, Q)
    TL = P_inv + _mm(_mm(PiQ, Sc_inv), PiQ.transpose(-1, -2))
    TR = -_mm(PiQ, Sc_inv)
    BL = TR.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Sc_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def kabsch(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor | None = None,
    power_iters: int = 24,
) -> torch.Tensor:
    """Weighted rigid alignment dst ~ T @ src by Horn's quaternion method:
    repeated normalised squaring of the shifted 4x4 profile matrix, then
    three Rayleigh-quotient steps. src, dst: (..., N, 3) -> (..., 4, 4)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-8)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    src_c = src - mu_s[..., None, :]
    dst_c = dst - mu_d[..., None, :]
    S = torch.sum((src_c * w[..., None])[..., :, :, None] * dst_c[..., :, None, :], dim=-3)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
            torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
            torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
            torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
        ],
        -2,
    )
    c = torch.sqrt(torch.sum(N * N, dim=(-2, -1))) + 1e-12
    eye4 = torch.eye(4, dtype=N.dtype, device=N.device)
    P = (N + c[..., None, None] * eye4) / c[..., None, None]
    for _ in range(max(5, (power_iters + 5) // 6)):
        P = _mm(P, P)
        P = P / (torch.sqrt(torch.sum(P * P, dim=(-2, -1), keepdim=True)) + 1e-30)
    Q = P / torch.clamp(torch.sqrt(torch.sum(P * P, dim=-1, keepdim=True)), min=1e-20)
    mu4 = torch.sum(_mm(Q, N) * Q, dim=-1)  # (..., 4)
    best = torch.argmax(mu4, dim=-1)
    q = torch.gather(Q, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    for _ in range(3):
        mu = torch.sum(q * _mv(N, q), dim=-1)
        shifted = N - (mu - 1e-6 * c)[..., None, None] * eye4
        x = _mv(_inv4x4_sym(shifted), q)
        n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        q = torch.where(n > 1e-18, x / torch.clamp(n, min=1e-30), q)
    R = lie.quat_to_matrix(torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], -1))
    t = mu_d - _mv(R, mu_s)
    return lie.make_pose(R, t)


def reprojection_residuals(
    T: torch.Tensor, points: torch.Tensor, observations: torch.Tensor, cam: PinholeCamera
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals proj(T p) - obs and a positive-depth mask."""
    p_cam = lie.transform_points(T, points)
    return project(p_cam, cam) - observations, p_cam[..., 2] > 0.05


def _pose_jacobian(p_cam: torch.Tensor, cam: PinholeCamera) -> torch.Tensor:
    """(N, 2, 6) Jacobian of the pixel residual w.r.t. a left tangent update."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    J_proj = torch.stack(
        [
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )
    I3 = torch.eye(3, dtype=p_cam.dtype, device=p_cam.device).expand(p_cam.shape[:-1] + (3, 3))
    J_p = torch.cat([I3, -lie.hat(p_cam)], dim=-1)
    return _mm(J_proj, J_p)


def huber_weights(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights of the Huber loss."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm), delta / torch.clamp(r_norm, min=1e-8))


class PnPResult(NamedTuple):
    pose: torch.Tensor  # (4, 4)
    num_inliers: torch.Tensor  # scalar int64
    inlier_mask: torch.Tensor  # (N,) bool
    rmse: torch.Tensor  # scalar, inlier reprojection rmse (px)


def refine_pose(
    T_init: torch.Tensor,
    points: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    weights: torch.Tensor | None = None,
    num_iters: int = 10,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
) -> torch.Tensor:
    """Damped Gauss-Newton on SE(3) minimising robust reprojection error."""
    w_conf = torch.ones_like(points[:, 0]) if weights is None else weights
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)
    T = T_init
    for _ in range(num_iters):
        r, depth_ok = reprojection_residuals(T, points, observations, cam)
        J_pose = _pose_jacobian(lie.transform_points(T, points), cam)
        w = huber_weights(torch.linalg.norm(r, dim=-1), huber_delta) * w_conf * depth_ok
        JW = J_pose * w[:, None, None]
        H = torch.einsum("nij,nik->jk", JW, J_pose) + damping * eye6
        g = torch.einsum("nij,ni->j", JW, r)
        delta = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        delta = torch.where(torch.isfinite(delta).all(), delta, torch.zeros_like(delta))
        T = _mm(lie.se3_exp(delta), T)
    return T


def count_inliers(
    T: torch.Tensor,
    points: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    valid: torch.Tensor,
    threshold: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inlier count and mask; T may carry leading hypothesis dims."""
    r, depth_ok = reprojection_residuals(T, points, observations, cam)
    mask = (torch.linalg.norm(r, dim=-1) < threshold) & depth_ok & valid
    return torch.sum(mask, dim=-1), mask


def sample_indices(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, u.shape, replace=True, p=probs)`` given
    the uniforms ``u = jax.random.uniform(key, u.shape)``: inverse CDF
    ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``."""
    p_cuml = torch.cumsum(probs, dim=0)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(u.shape)


def ransac_pose(
    u: torch.Tensor,
    points: torch.Tensor,
    points_dst: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    valid: torch.Tensor,
    weights: torch.Tensor | None = None,
    inlier_threshold: float = 3.0,
    refine_iters: int = 10,
) -> PnPResult:
    """Fixed-budget RANSAC + robust GN polish for RGB-D correspondences.

    ``u`` (H, 3) uniforms in [0, 1) drive the minimal-sample draw (H
    hypotheses of 3 points, biased to valid high-weight correspondences).
    Hypotheses are 3-point Kabsch fits of ``points`` onto ``points_dst``,
    scored by semantically weighted inlier support on ``observations``;
    the best is refined with Gauss-Newton and kept only if support does
    not drop.
    """
    w_sem = valid.to(points.dtype) if weights is None else valid.to(points.dtype) * weights
    probs = w_sem + 1e-6
    probs = probs / probs.sum()
    idx = sample_indices(probs, u)  # (H, 3)

    Ts = kabsch(points[idx], points_dst[idx])  # (H, 4, 4)
    inls, masks = count_inliers(Ts, points, observations, cam, valid, inlier_threshold)
    supports = torch.sum(masks * w_sem, dim=-1)
    best = torch.argmax(supports)
    T_best = Ts[best]

    _, mask = count_inliers(T_best, points, observations, cam, valid, inlier_threshold)
    w = mask.to(points.dtype)
    if weights is not None:
        w = w * weights
    T_ref = refine_pose(T_best, points, observations, cam, weights=w, num_iters=refine_iters)
    inl_ref, mask_ref = count_inliers(T_ref, points, observations, cam, valid, inlier_threshold)
    sup_ref = torch.sum(mask_ref * w_sem)
    use_ref = sup_ref >= supports[best]
    T_final = torch.where(use_ref, T_ref, T_best)
    inl_final = torch.where(use_ref, inl_ref, inls[best])
    mask_final = torch.where(use_ref, mask_ref, mask)

    r, _ = reprojection_residuals(T_final, points, observations, cam)
    err2 = torch.sum(r * r, dim=-1)
    rmse = torch.sqrt(torch.sum(err2 * mask_final) / torch.clamp(torch.sum(mask_final), min=1))
    return PnPResult(pose=T_final, num_inliers=inl_final, inlier_mask=mask_final, rmse=rmse)
