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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector (principal branch)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5
    s_sq = torch.sum(w * w, dim=-1)
    small = s_sq < 1e-12
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s_sq), s_sq))
    theta = torch.atan2(s_safe, cos_theta)
    scale = torch.where(small, 1.0 + s_sq / 6.0, theta / s_safe)
    phi = w * scale[..., None]
    near_pi = cos_theta < -1.0 + 1e-6
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    one = torch.ones_like(trace)
    s0 = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    s1 = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    s2 = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis = axis * torch.stack([s0, s1, s2], dim=-1)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    phi_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi)


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


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta_sq, theta_sq_safe, theta, small = _safe_theta(phi)
    K = hat(phi)
    half = theta * 0.5
    cot_coeff = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / theta_sq_safe,
    )
    eye = _eye(3, phi).expand(K.shape)
    return eye - 0.5 * K + cot_coeff[..., None, None] * mm_small(K, K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential. ``xi = (rho, phi)`` (..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = mv_small(_so3_left_jacobian(phi), rho)
    return make_pose(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm. (..., 4, 4) -> ``xi = (rho, phi)`` (..., 6)."""
    phi = so3_log(T[..., :3, :3])
    rho = mv_small(_so3_left_jacobian_inv(phi), T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


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


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> TUM-order quaternion ``(qx, qy, qz, qw)``
    (branch-free Shepperd's method, canonical sign qw >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    sw = 2.0 * _safe_sqrt(qw2)
    cand_w = torch.stack(
        [(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4.0], dim=-1
    )
    sx = 2.0 * _safe_sqrt(qx2)
    cand_x = torch.stack(
        [sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], dim=-1
    )
    sy = 2.0 * _safe_sqrt(qy2)
    cand_y = torch.stack(
        [(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy, (m02 - m20) / sy], dim=-1
    )
    sz = 2.0 * _safe_sqrt(qz2)
    cand_z = torch.stack(
        [(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0, (m10 - m01) / sz], dim=-1
    )
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)

