"""Gauss-Newton pose refinement of one RANSAC result in one launch: CUDA
kernel wrapper and its plain version.

The kernel (``csrc/pnp_refine.cu``) replaces no TPU kernel. It is the span
``slam.refine`` of ``slam/pnp.py::ransac_pose`` -- the robust Gauss-Newton
polish of the best hypothesis, its rescoring, the refine-or-keep choice
and the inlier rmse -- which in plain PyTorch is about 1,500 launches and
12 host syncs a tracked frame. The kernel reads the best hypothesis's
inlier count through the device index ``best``, so nothing is read on the
host.

``pnp_refine(...)`` takes the RANSAC span's results and returns
``(pose (4, 4) f32, num_inliers int64 0-dim, inlier_mask (N,) bool, rmse
f32 0-dim)``: the kernel for CUDA tensors, ``pnp_refine_plain`` for CPU
tensors. On the card the kernel rounds every operation of the Gauss-Newton
steps as the plain version's PyTorch, cuBLAS and cuSOLVER calls do at the
SLAM paths' 500 and 512 correspondences, so the two give the same pose
bits there (the SLAM loop's window bundle adjustment would amplify a
difference in the last bit); elsewhere they agree to rounding. Both keep
the refined pose when ``torch.sum(mask_ref * w_sem)`` is not below
``supports[best]``; the kernel sums in ``torch.sum``'s order on the card
and reads ``supports[best]`` itself, so the choice follows the same bits.
"""

from __future__ import annotations

import torch

from ...core.camera import PinholeCamera
from ...utils import profiling

# Up to this many points the kernel keeps their rows in shared memory
# (kSmemPoints in csrc/pnp_refine.cu); above, in a scratch buffer.
SMEM_POINTS = 2048


def _check(T_best, points, observations, w, w_sem, valid, mask, supports, inls, best) -> None:
    N = points.shape[0]
    shapes = {
        "T_best": (T_best, (4, 4), torch.float32), "points": (points, (N, 3), torch.float32),
        "observations": (observations, (N, 2), torch.float32), "w": (w, (N,), torch.float32),
        "w_sem": (w_sem, (N,), torch.float32), "valid": (valid, (N,), torch.bool),
        "mask": (mask, (N,), torch.bool), "supports": (supports, (supports.numel(),), torch.float32),
        "inls": (inls, (supports.numel(),), torch.int64), "best": (best, (), torch.int64),
    }
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} of shape {shape} (N = {N}), "
                             f"got {x.dtype} of shape {tuple(x.shape)}")
        if x.device != points.device:
            raise ValueError(f"{name} on {x.device} but points on {points.device}")
    if supports.numel() == 0:
        raise ValueError("supports: no hypotheses")


def pnp_refine(
    T_best: torch.Tensor,
    points: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    w: torch.Tensor,
    w_sem: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    supports: torch.Tensor,
    inls: torch.Tensor,
    best: torch.Tensor,
    threshold: float = 3.0,
    num_iters: int = 10,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
):
    """Refine ``T_best`` by ``num_iters`` damped Gauss-Newton steps with
    Huber weights times ``w``, rescore it (inliers within ``threshold`` px,
    support weighted by ``w_sem``), keep it if its support is not below
    ``supports[best]``, that of ``mask`` (else ``T_best``, ``inls[best]``
    and ``mask``) and return (pose, num_inliers, inlier_mask, rmse): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return pnp_refine_plain(T_best, points, observations, cam, w, w_sem, valid, mask, supports, inls,
                                best, threshold, num_iters, huber_delta, damping)
    _check(T_best, points, observations, w, w_sem, valid, mask, supports, inls, best)
    if points.device.type != "cuda":
        raise ValueError(f"pnp_refine: unsupported device {points.device}")
    from . import build

    args = [x.contiguous() for x in (T_best, points, observations, w, w_sem, valid, mask, supports, inls, best)]
    N = points.shape[0]
    dev = points.device
    # A point's Jacobian rows, weight and residual, 16 floats.
    scratch = torch.empty((N, 16), dtype=torch.float32, device=dev) if N > SMEM_POINTS else None
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    num_inliers = torch.empty((), dtype=torch.int64, device=dev)
    inlier_mask = torch.empty((N,), dtype=torch.bool, device=dev)
    rmse = torch.empty((), dtype=torch.float32, device=dev)
    status = build.library().semslam_pnp_refine(
        *[x.data_ptr() for x in args], None if scratch is None else scratch.data_ptr(), pose.data_ptr(),
        num_inliers.data_ptr(), inlier_mask.data_ptr(), rmse.data_ptr(), N, num_iters, cam.fx, cam.fy, cam.cx,
        cam.cy, huber_delta, damping, threshold, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "semslam_pnp_refine")
    pnp_refine.launches += 1
    profiling.count("refine_kernels")
    return pose, num_inliers, inlier_mask, rmse


def pnp_refine_plain(
    T_best: torch.Tensor,
    points: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    w: torch.Tensor,
    w_sem: torch.Tensor,
    valid: torch.Tensor,
    mask: torch.Tensor,
    supports: torch.Tensor,
    inls: torch.Tensor,
    best: torch.Tensor,
    threshold: float = 3.0,
    num_iters: int = 10,
    huber_delta: float = 3.0,
    damping: float = 1e-4,
):
    """The plain version of ``pnp_refine``, on any device: Gauss-Newton in
    eager PyTorch; indexing with the 0-dim ``best`` reads it on the host, a
    ``sync`` each time."""
    from ...slam import pnp  # here: slam/pnp.py imports this module

    T_ref = pnp.refine_pose(T_best, points, observations, cam, weights=w, num_iters=num_iters,
                            huber_delta=huber_delta, damping=damping)
    inl_ref, mask_ref = pnp.count_inliers(T_ref, points, observations, cam, valid, threshold)
    sup_ref = torch.sum(mask_ref * w_sem)
    with profiling.sync("refine.best_support"):
        best_support = supports[best]
    use_ref = sup_ref >= best_support
    T_final = torch.where(use_ref, T_ref, T_best)
    with profiling.sync("refine.best_inliers"):
        best_inliers = inls[best]
    inl_final = torch.where(use_ref, inl_ref, best_inliers)
    mask_final = torch.where(use_ref, mask_ref, mask)

    r, _ = pnp.reprojection_residuals(T_final, points, observations, cam)
    err2 = torch.sum(r * r, dim=-1)
    rmse = torch.sqrt(torch.sum(err2 * mask_final) / torch.clamp(torch.sum(mask_final), min=1))
    return T_final, inl_final, mask_final, rmse


pnp_refine.launches = 0
