# Frozen copy of semantic_slam_master_tpu_torch/core/lie.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""SO(3)/SE(3) Lie-group math on tensors (port of ``core/lie.py``).

Conventions as in the JAX package: 3x3 rotations, 4x4 poses mapping
world points into the camera frame, TUM quaternion order
``(qx, qy, qz, qw)``, SE(3) tangent ``(rho, phi)``. Tiny-matrix products
are multiply-reduce, as there, so both packages do the same f32
arithmetic.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def mm_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Tiny-matrix product (..., m, k) @ (..., k, n) as multiply-reduce."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def mv_small(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tiny matvec (..., m, k) @ (..., k) as multiply-reduce."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (leading batch dims allowed)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _safe_theta(phi: torch.Tensor):
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return theta_sq, theta_sq_safe, torch.sqrt(theta_sq_safe), small


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle 3-vector -> rotation matrix."""
    theta_sq, theta_sq_safe, theta, small = _safe_theta(phi)
    K = hat(phi)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe
    )
    eye = _eye(3, phi).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * mm_small(K, K)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta_sq, theta_sq_safe, theta, small = _safe_theta(phi)
    K = hat(phi)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (theta_sq_safe * theta),
    )
    eye = _eye(3, phi).expand(K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * mm_small(K, K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. ``xi = (rho, phi)`` (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = mv_small(_so3_left_jacobian(phi), rho)
    return make_pose(R, t)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous transform from R (..., 3, 3) and t (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_pose(Rt, -mv_small(Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.sum(pts[..., :, None, :] * R[..., None, :, :], dim=-1) + t[..., None, :]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """TUM-order quaternion ``(qx, qy, qz, qw)`` -> rotation matrix."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (qy**2 + qz**2)
    r01 = 2 * (qx * qy - qz * qw)
    r02 = 2 * (qx * qz + qy * qw)
    r10 = 2 * (qx * qy + qz * qw)
    r11 = 1 - 2 * (qx**2 + qz**2)
    r12 = 2 * (qy * qz - qx * qw)
    r20 = 2 * (qx * qz - qy * qw)
    r21 = 2 * (qy * qz + qx * qw)
    r22 = 1 - 2 * (qx**2 + qy**2)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


