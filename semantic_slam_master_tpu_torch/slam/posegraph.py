"""Pose-graph optimisation for loop closure (port of ``slam/posegraph.py``).

Given a chain of odometry edges plus loop-closure edges between keyframe
poses (camera-in-world), minimise

    sum_e w_e || log( Z_e^{-1} (T_i^{-1} T_j) ) ||^2

by damped Gauss-Newton on the SE(3) tangent of every pose, with the
dense (6E, 6K) Jacobian from forward-mode autodiff (``torch.func.jacfwd``,
as the JAX package uses ``jax.jacfwd``; taken per edge in its two ends'
tangents, the only non-zero blocks, then placed). Pose 0 is pinned by a strong
prior. The solve runs in full f32 (TF32 is off in the port,
``core/precision.py``), and a step with a non-finite entry is dropped.

``close_loops`` pads the keyframe and loop-edge counts to the JAX
package's buckets (there they bound jit recompiles; here they make the
port solve the same linear system JAX solves): padding keyframes repeat
the last pose (identity chain edges, zero residual), padding loop edges
are zero-weight self-edges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core import lie


class PoseGraph(NamedTuple):
    """poses (K, 4, 4) camera-in-world initial estimates; edges i -> j with
    measured relative transforms Z = T_i^{-1} T_j (4, 4) and weights."""

    poses: torch.Tensor  # (K, 4, 4)
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_T: torch.Tensor  # (E, 4, 4)
    edge_weight: torch.Tensor  # (E,)


def _relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^{-1} b for rigid transforms (..., 4, 4)."""
    return lie.mm_small(lie.pose_inverse(a), b)


def chain_edges(poses: torch.Tensor, weight: float = 1.0):
    """Odometry edges (k, k+1) from a trajectory estimate."""
    K = poses.shape[0]
    i = torch.arange(K - 1, device=poses.device)
    Z = _relative(poses[:-1], poses[1:])
    return i, i + 1, Z, torch.full((K - 1,), weight, dtype=poses.dtype, device=poses.device)


def _residuals(xi: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Stacked weighted edge residuals for tangent updates xi (K, 6):
    T_k = exp(xi_k) @ T_k0."""
    poses = lie.mm_small(lie.se3_exp(xi), graph.poses)
    pred = _relative(poses[graph.edge_i], poses[graph.edge_j])
    err = lie.se3_log(_relative(graph.edge_T, pred))  # (E, 6)
    return (err * torch.sqrt(graph.edge_weight)[:, None]).reshape(-1)


def _edge_residual(xi_i, xi_j, T_i, T_j, Z, w):
    """One edge's weighted residual for tangent updates of its two ends."""
    P_i = lie.mm_small(lie.se3_exp(xi_i), T_i)
    P_j = lie.mm_small(lie.se3_exp(xi_j), T_j)
    return lie.se3_log(_relative(Z, _relative(P_i, P_j))) * torch.sqrt(w)


# d(residual_e) / d(xi_i, xi_j) at xi = 0, per edge: (E, 6, 6) twice.
_edge_jacobians = vmap(jacfwd(_edge_residual, argnums=(0, 1)))


def _jacobian(graph: PoseGraph) -> torch.Tensor:
    """The dense (6E, 6K) Jacobian of ``_residuals`` at xi = 0, as
    ``jax.jacfwd`` gives it: forward-mode derivatives of each edge's
    residual in its two ends' tangents (every other entry is exactly 0),
    summed where an edge joins a pose to itself. (Under ``jacfwd`` the
    lie helpers' ``torch.where`` with a Python-scalar branch promotes the
    tangents to f64; the blocks are cast back to the poses' f32.)"""
    K, E = graph.poses.shape[0], graph.edge_i.shape[0]
    dt = graph.poses.dtype
    zeros = torch.zeros((E, 6), dtype=dt, device=graph.poses.device)
    J_i, J_j = _edge_jacobians(zeros, zeros, graph.poses[graph.edge_i], graph.poses[graph.edge_j],
                               graph.edge_T, graph.edge_weight)
    J_i, J_j = J_i.to(dt), J_j.to(dt)
    J = torch.zeros((E, K, 6, 6), dtype=dt, device=J_i.device)
    rows = torch.arange(E, device=J.device)
    J.index_put_((rows, graph.edge_i), J_i, accumulate=True)
    J.index_put_((rows, graph.edge_j), J_j, accumulate=True)
    return J.permute(0, 2, 1, 3).reshape(6 * E, 6 * K)


def optimize(graph: PoseGraph, num_iters: int = 10, damping: float = 1e-6,
             gauge_weight: float = 1e6) -> torch.Tensor:
    """Gauss-Newton pose-graph solve. Returns optimised poses (K, 4, 4)."""
    K = graph.poses.shape[0]
    dev, dt = graph.poses.device, graph.poses.dtype
    eye6 = torch.arange(6, device=dev)
    damp = damping * torch.eye(K * 6, dtype=dt, device=dev)
    x0 = torch.zeros((K, 6), dtype=dt, device=dev)
    poses = graph.poses
    for _ in range(num_iters):
        g = graph._replace(poses=poses)
        r = _residuals(x0, g)
        J = _jacobian(g)
        H = J.T @ J
        H[eye6, eye6] += gauge_weight  # gauge prior on pose 0
        H = H + damp
        delta = -torch.linalg.solve(H, J.T @ r)
        delta = torch.where(torch.isfinite(delta).all(), delta, torch.zeros_like(delta))
        poses = lie.mm_small(lie.se3_exp(delta.reshape(K, 6)), poses)
    return poses


# The JAX package's shape buckets (keyframes, loop edges).
_K_BUCKET = 32
_E_BUCKET = 8


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def close_loops(
    poses_kf: torch.Tensor,
    loop_edges,  # [(i_kf, j_kf, T_rel (4, 4), weight)]
    odometry_weight: float = 1.0,
    num_iters: int = 10,
    pad_shapes: bool = True,
) -> torch.Tensor:
    """Odometry chain + loop edges -> optimised keyframe poses (K, 4, 4).
    ``T_rel`` measures T_i^{-1} T_j. With ``pad_shapes`` the graph is
    padded to the JAX package's buckets (module docstring); the returned
    slice is the K real poses."""
    K = int(poses_kf.shape[0])
    dev = poses_kf.device
    Kp = max(_round_up(K, _K_BUCKET), _K_BUCKET) if pad_shapes else K
    poses_pad = torch.cat([poses_kf, poses_kf[-1:].expand(Kp - K, 4, 4)]) if Kp > K else poses_kf

    ei, ej, eT, ew = chain_edges(poses_pad, odometry_weight)
    n_loop = len(loop_edges)
    Ep = max(_round_up(n_loop, _E_BUCKET), _E_BUCKET) if pad_shapes else n_loop
    if Ep:
        li = torch.zeros(Ep, dtype=torch.int64, device=dev)
        lj = torch.zeros(Ep, dtype=torch.int64, device=dev)
        lT = torch.eye(4, dtype=torch.float32, device=dev).repeat(Ep, 1, 1)
        lw = torch.zeros(Ep, dtype=torch.float32, device=dev)
        if n_loop:
            li[:n_loop] = torch.tensor([e[0] for e in loop_edges], device=dev)
            lj[:n_loop] = torch.tensor([e[1] for e in loop_edges], device=dev)
            lT[:n_loop] = torch.stack([torch.as_tensor(e[2], dtype=torch.float32).to(dev)
                                       for e in loop_edges])
            lw[:n_loop] = torch.tensor([float(e[3]) for e in loop_edges], device=dev)
        ei, ej = torch.cat([ei, li]), torch.cat([ej, lj])
        eT, ew = torch.cat([eT, lT]), torch.cat([ew, lw])
    graph = PoseGraph(poses=poses_pad, edge_i=ei, edge_j=ej, edge_T=eT, edge_weight=ew)
    return optimize(graph, num_iters=num_iters)[:K]
