"""Local bundle adjustment: Levenberg-Marquardt with a Schur complement
(port of ``slam/ba.py``).

Fixed problem shape: K keyframe cameras, M landmarks, a dense (K, M)
observation grid with a validity mask. Residuals are [du, dv, w_d * dz]
with Huber IRLS weights times a per-observation confidence; camera 0 is
held by a strong gauge prior. Per iteration the point blocks are
eliminated, the (6K, 6K) reduced camera system is solved, points are
back-substituted, and the step is accepted iff the robust cost drops.
The JAX ``lax.scan`` over iterations is a Python loop here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.camera import PinholeCamera, project
from ..core.fixed import inv3x3
from .pnp import huber_weights


class BAProblem(NamedTuple):
    """poses (K, 4, 4) world->camera, points (M, 3), observations
    (K, M, 2), valid (K, M) bool, confidence (K, M), obs_depth (K, M)
    (0 = no depth)."""

    poses: torch.Tensor
    points: torch.Tensor
    observations: torch.Tensor
    valid: torch.Tensor
    confidence: torch.Tensor
    obs_depth: torch.Tensor


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _residuals_and_weights(poses, points, problem: BAProblem, cam, huber_delta, depth_weight):
    """r (K, M, 3), IRLS weights (K, M), p_cam (K, M, 3), depth-row scale (K, M)."""
    p_cam = lie.transform_points(poses, points)  # (K, M, 3)
    r_uv = project(p_cam, cam) - problem.observations
    depth_scale = depth_weight * (problem.obs_depth > 0.05).to(p_cam.dtype)
    r_z = depth_scale * (p_cam[..., 2] - problem.obs_depth)
    r = torch.cat([r_uv, r_z[..., None]], dim=-1)
    depth_ok = p_cam[..., 2] > 0.05
    w = (
        huber_weights(torch.linalg.norm(r, dim=-1), huber_delta)
        * problem.confidence
        * problem.valid
        * depth_ok
    )
    return r, w, p_cam, depth_scale


def _robust_cost(r, w):
    return torch.sum(w * torch.sum(r * r, dim=-1))


def bundle_adjust(
    problem: BAProblem,
    cam: PinholeCamera,
    num_iters: int = 8,
    huber_delta: float = 3.0,
    init_lambda: float = 1e-3,
    gauge_prior: float = 1e8,
    point_prior: float = 1e-6,
    depth_weight: float = 30.0,
) -> BAResult:
    """Levenberg-Marquardt over (poses, points) with accept/reject damping
    (lambda /3 on accept, x5 on reject, clipped to [1e-8, 1e6])."""
    poses, points = problem.poses, problem.points
    K, M = problem.valid.shape
    dtype, dev = poses.dtype, poses.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    gauge = gauge_prior * (torch.arange(K, device=dev) == 0).to(dtype)

    def cost_of(poses, points):
        r, w, _, _ = _residuals_and_weights(poses, points, problem, cam, huber_delta, depth_weight)
        return _robust_cost(r, w)

    init_cost = cost_of(poses, points)
    lam = torch.tensor(init_lambda, dtype=dtype, device=dev)
    for _ in range(num_iters):
        r, w, p_cam, depth_scale = _residuals_and_weights(
            poses, points, problem, cam, huber_delta, depth_weight
        )
        cost = _robust_cost(r, w)

        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        iz = 1.0 / z_safe
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        # J3: d(residual rows u, v, depth) / d(p_cam), as (K, M) planes.
        J3 = [
            [cam.fx * iz, zero, -cam.fx * x * iz2],
            [zero, cam.fy * iz, -cam.fy * y * iz2],
            [zero, zero, depth_scale],
        ]
        # A = J3 @ [I | -hat(p)]: pose Jacobian, 3 x 6 planes.
        A = torch.stack(
            [
                torch.stack(
                    [
                        J3[i][0],
                        J3[i][1],
                        J3[i][2],
                        -(J3[i][1] * z - J3[i][2] * y),
                        -(-J3[i][0] * z + J3[i][2] * x),
                        -(J3[i][0] * y - J3[i][1] * x),
                    ]
                )
                for i in range(3)
            ]
        )  # (3, 6, K, M)
        # B = J3 @ R_k: point Jacobian, (3, 3, K, M).
        J3t = torch.stack([torch.stack(row) for row in J3])  # (3, 3, K, M)
        Rs = poses[:, :3, :3]  # (K, 3, 3)
        B = torch.einsum("ijkm,kjl->ilkm", J3t, Rs)
        rr = r.permute(2, 0, 1)  # (3, K, M)

        U = torch.einsum("ijkm,ilkm->kjl", A * w, A)  # (K, 6, 6)
        g_c = -torch.einsum("ijkm,ikm->kj", A * w, rr)  # (K, 6)
        V = torch.einsum("ijkm,ilkm->mjl", B * w, B)  # (M, 3, 3)
        g_p = -torch.einsum("ijkm,ikm->mj", B * w, rr)  # (M, 3)

        U = U + (lam + gauge)[:, None, None] * eye6
        V = V + (lam + point_prior) * eye3
        V_inv = inv3x3(V)  # (M, 3, 3)
        Wb = torch.einsum("ijkm,ilkm->kmjl", A * w, B)  # (K, M, 6, 3)
        WVi = torch.einsum("kmjl,mlp->kmjp", Wb, V_inv)  # (K, M, 6, 3)
        # Reduced camera system S = U - W V^-1 W^T, as one product over (m, p).
        X = WVi.permute(0, 2, 1, 3).reshape(K * 6, M * 3)
        Y = Wb.permute(0, 2, 1, 3).reshape(K * 6, M * 3)
        S = -(X @ Y.T)
        S = S.reshape(K, 6, K, 6)
        kk = torch.arange(K, device=dev)
        S[kk, :, kk, :] += U
        rhs = g_c - torch.einsum("kmjp,mp->kj", WVi, g_p)
        delta_c = torch.linalg.solve_ex(S.reshape(6 * K, 6 * K), rhs.reshape(6 * K, 1))[0]
        delta_c = delta_c.reshape(K, 6)
        t = g_p - torch.einsum("kmjl,kj->ml", Wb, delta_c)
        delta_p = torch.einsum("mjl,ml->mj", V_inv, t)

        finite = torch.isfinite(delta_c).all() & torch.isfinite(delta_p).all()
        delta_c = torch.where(finite, delta_c, torch.zeros_like(delta_c))
        delta_p = torch.where(finite, delta_p, torch.zeros_like(delta_p))
        new_poses = torch.matmul(lie.se3_exp(delta_c), poses)
        new_points = points + delta_p
        accept = cost_of(new_poses, new_points) < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 5.0), 1e-8, 1e6)
    return BAResult(poses=poses, points=points, initial_cost=init_cost, final_cost=cost_of(poses, points))
