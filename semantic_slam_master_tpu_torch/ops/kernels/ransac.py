"""The RANSAC hypotheses of one tracked frame in one launch: CUDA kernel
wrapper and its plain version.

The kernel (``csrc/ransac.cu``) replaces no TPU kernel. It is the span
``slam.ransac`` of ``slam/pnp.py::ransac_pose`` -- the minimal-sample draw,
the H Kabsch fits, their inlier masks and semantic supports, the best
hypothesis and its inlier mask -- which in plain PyTorch is about 350
launches and two host syncs a tracked frame (indexing the fits with the
0-dim argmax, and ``lie.make_pose``'s constant row inside ``kabsch``). On
the card the span is at most eight launches and reads nothing on the host:
the draw's weights and ``torch.cumsum`` (PyTorch), then the kernel, whose
outputs ``pnp_refine`` reads on the device.

``ransac(...)`` returns a ``Hypotheses``: the kernel for CUDA tensors,
``ransac_plain`` (the span's eager code) for CPU tensors. On the card the
kernel rounds every operation and every sum as the plain version's PyTorch
calls do, so the two give the same bits in every output (measured at the
SLAM paths' 500 and 512 correspondences with 64 hypotheses; the SLAM loop's
window bundle adjustment would amplify a difference in the last bit).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.camera import PinholeCamera
from ...utils import profiling


class Hypotheses(NamedTuple):
    Ts: torch.Tensor  # (H, 4, 4) f32, the fits
    T_best: torch.Tensor  # (4, 4) f32, Ts[best]
    w_sem: torch.Tensor  # (N,) f32, valid * weights
    supports: torch.Tensor  # (H,) f32, sum(masks * w_sem) a hypothesis
    inls: torch.Tensor  # (H,) int64, inliers a hypothesis
    best: torch.Tensor  # () int64, argmax(supports)
    mask: torch.Tensor  # (N,) bool, T_best's inliers
    w: torch.Tensor  # (N,) f32, mask * weights


def _check(u, points, points_dst, observations, valid, weights) -> None:
    N, H = points.shape[0], u.shape[0]
    shapes = {
        "u": (u, (H, 3), torch.float32), "points": (points, (N, 3), torch.float32),
        "points_dst": (points_dst, (N, 3), torch.float32), "observations": (observations, (N, 2), torch.float32),
        "valid": (valid, (N,), torch.bool),
    }
    if weights is not None:
        shapes["weights"] = (weights, (N,), torch.float32)
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} of shape {shape} (H = {H}, N = {N}), "
                             f"got {x.dtype} of shape {tuple(x.shape)}")
        if x.device != points.device:
            raise ValueError(f"{name} on {x.device} but points on {points.device}")
    if H == 0:
        raise ValueError("u: no hypotheses")
    if N == 0:
        raise ValueError("points: nothing to draw from")


def _sampling_weights(valid: torch.Tensor, weights: torch.Tensor | None, dtype):
    """(w_sem, probs): the semantic weights of the valid correspondences and
    the draw's probabilities."""
    w_sem = valid.to(dtype) if weights is None else valid.to(dtype) * weights
    probs = w_sem + 1e-6
    return w_sem, probs / probs.sum()


def ransac(
    u: torch.Tensor,
    points: torch.Tensor,
    points_dst: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    valid: torch.Tensor,
    weights: torch.Tensor | None = None,
    threshold: float = 3.0,
) -> Hypotheses:
    """Draw H = ``u.shape[0]`` minimal samples of 3 correspondences (inverse
    CDF of the uniforms ``u`` (H, 3) over ``valid * weights + 1e-6``), fit
    ``points`` onto ``points_dst`` by Kabsch on each, score each by its
    inliers on ``observations`` (within ``threshold`` px, in front of the
    camera, valid) weighted by ``w_sem``, and take the best with its inlier
    mask: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if points.device.type == "cpu":
        return ransac_plain(u, points, points_dst, observations, cam, valid, weights, threshold)
    _check(u, points, points_dst, observations, valid, weights)
    if points.device.type != "cuda":
        raise ValueError(f"ransac: unsupported device {points.device}")
    w_sem, probs = _sampling_weights(valid, weights, points.dtype)
    return _launch(u, torch.cumsum(probs, dim=0), w_sem, points, points_dst, observations, cam, valid, weights,
                   threshold)


def _launch(u, p_cuml, w_sem, points, points_dst, observations, cam, valid, weights, threshold) -> Hypotheses:
    """The kernel alone, given the draw's cumulative probabilities
    ``p_cuml`` and ``w_sem``: allocates the outputs, launches on the current
    stream without a synchronise, counts the launch."""
    from . import build

    H, N = u.shape[0], points.shape[0]
    dev = points.device
    ins = [x.contiguous() for x in (u, p_cuml, points, points_dst, observations, valid, w_sem)]
    weights = None if weights is None else weights.contiguous()
    out = Hypotheses(
        Ts=torch.empty((H, 4, 4), dtype=torch.float32, device=dev),
        T_best=torch.empty((4, 4), dtype=torch.float32, device=dev), w_sem=w_sem,
        supports=torch.empty((H,), dtype=torch.float32, device=dev),
        inls=torch.empty((H,), dtype=torch.int64, device=dev), best=torch.empty((), dtype=torch.int64, device=dev),
        mask=torch.empty((N,), dtype=torch.bool, device=dev), w=torch.empty((N,), dtype=torch.float32, device=dev),
    )
    status = build.library().semslam_ransac(
        *[x.data_ptr() for x in ins], None if weights is None else weights.data_ptr(),
        *[x.data_ptr() for x in (out.Ts, out.T_best, out.inls, out.supports, out.best, out.mask, out.w)],
        H, N, cam.fx, cam.fy, cam.cx, cam.cy, threshold, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "semslam_ransac")
    ransac.launches += 1
    profiling.count("ransac_kernels")
    return out


def ransac_plain(
    u: torch.Tensor,
    points: torch.Tensor,
    points_dst: torch.Tensor,
    observations: torch.Tensor,
    cam: PinholeCamera,
    valid: torch.Tensor,
    weights: torch.Tensor | None = None,
    threshold: float = 3.0,
) -> Hypotheses:
    """The plain version of ``ransac``, on any device: eager PyTorch;
    indexing the fits with the 0-dim ``best`` reads it on the host, a
    ``sync``, as does ``kabsch``'s ``lie.make_pose``."""
    from ...slam import pnp  # here: slam/pnp.py imports this module

    w_sem, probs = _sampling_weights(valid, weights, points.dtype)
    idx = pnp.sample_indices(probs, u)  # (H, 3)

    Ts = pnp.kabsch(points[idx], points_dst[idx])  # (H, 4, 4)
    inls, masks = pnp.count_inliers(Ts, points, observations, cam, valid, threshold)
    supports = torch.sum(masks * w_sem, dim=-1)
    best = torch.argmax(supports)
    with profiling.sync("ransac.best_pose"):
        T_best = Ts[best]

    _, mask = pnp.count_inliers(T_best, points, observations, cam, valid, threshold)
    w = mask.to(points.dtype)
    if weights is not None:
        w = w * weights
    return Hypotheses(Ts, T_best, w_sem, supports, inls, best, mask, w)


ransac.launches = 0
