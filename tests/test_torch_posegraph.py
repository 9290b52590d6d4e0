"""Port parity: ``slam/posegraph.py`` of semantic_slam_master_tpu_torch
against the JAX package's on the CPU, on a drifting 12-keyframe loop
with one exact loop edge (tests/test_bow_posegraph.py's graph) and on a
40-keyframe graph that crosses a padding bucket with several loop edges.

Tolerance: optimised poses within 1e-4 (translation in metres, rotation
entries), the f32 Gauss-Newton's rounding: the port differentiates with
``torch.func.jacfwd`` where JAX uses ``jax.jacfwd``, and LU solves of the
(6K, 6K) normal equations sum in the libraries' own orders. The chain
edges and residuals at the start agree within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import lie as jlie
from semantic_slam_master_tpu.slam import posegraph as jpg
from semantic_slam_master_tpu_torch.slam import posegraph as tpg


def _drifting_loop(K, step_xi, noisy_xi):
    def walk(xi):
        step = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
        out = [np.eye(4)]
        for _ in range(K - 1):
            out.append(out[-1] @ step)
        return np.stack(out)

    return walk(step_xi), walk(noisy_xi)


def _close(est, edges):
    j = np.asarray(jpg.close_loops(jnp.asarray(est, jnp.float32),
                                   [(i, k, jnp.asarray(T, jnp.float32), w) for i, k, T, w in edges]))
    t = tpg.close_loops(torch.tensor(est, dtype=torch.float32),
                        [(i, k, torch.tensor(T, dtype=torch.float32), w) for i, k, T, w in edges]).numpy()
    return j, t


def test_close_loops_matches_jax_on_drifting_square():
    K = 12
    gt, est = _drifting_loop(K, [0.5, 0, 0, 0, np.pi / 6, 0], [0.52, 0.005, 0, 0, np.pi / 6 + 0.02, 0])
    edges = [(0, K - 1, np.linalg.inv(gt[0]) @ gt[-1], 10.0)]
    j, t = _close(est, edges)
    np.testing.assert_allclose(t, j, atol=1e-4)
    drift_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    drift_after = np.linalg.norm(t[-1][:3, 3] - gt[-1][:3, 3])
    assert drift_after < 0.3 * drift_before


@pytest.mark.parametrize("pad_shapes", [True, False])
def test_close_loops_matches_jax_across_buckets(pad_shapes):
    K = 40  # two keyframe buckets of 32
    gt, est = _drifting_loop(K, [0.2, 0, 0.01, 0, np.pi / 20, 0.01],
                             [0.205, 0.003, 0.01, 0.002, np.pi / 20 + 0.004, 0.01])
    edges = [(a, b, np.linalg.inv(gt[a]) @ gt[b], 5.0) for a, b in ((0, 39), (0, 20), (5, 38))]
    j = np.asarray(jpg.close_loops(jnp.asarray(est, jnp.float32),
                                   [(a, b, jnp.asarray(T, jnp.float32), w) for a, b, T, w in edges],
                                   pad_shapes=pad_shapes))
    t = tpg.close_loops(torch.tensor(est, dtype=torch.float32),
                        [(a, b, torch.tensor(T, dtype=torch.float32), w) for a, b, T, w in edges],
                        pad_shapes=pad_shapes).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    assert np.abs(t[0] - est[0]).max() < 1e-3  # the gauge holds pose 0


def test_residuals_and_chain_edges_match_jax():
    _, est = _drifting_loop(6, [0.3, 0, 0, 0, 0.2, 0], [0.31, 0.01, 0, 0, 0.21, 0])
    je = jpg.chain_edges(jnp.asarray(est, jnp.float32))
    te = tpg.chain_edges(torch.tensor(est, dtype=torch.float32))
    for a, b in zip(te, je):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    rng = np.random.default_rng(0)
    xi = (0.01 * rng.standard_normal((6, 6))).astype(np.float32)
    Z = np.asarray(je[2]) @ np.asarray(jlie.se3_exp(jnp.asarray([0.01, 0, 0, 0, 0, 0.02])))
    jg = jpg.PoseGraph(poses=jnp.asarray(est, jnp.float32), edge_i=je[0], edge_j=je[1],
                       edge_T=jnp.asarray(Z, jnp.float32), edge_weight=je[3] * 2.0)
    tg = tpg.PoseGraph(poses=torch.tensor(est, dtype=torch.float32), edge_i=te[0], edge_j=te[1],
                       edge_T=torch.tensor(Z, dtype=torch.float32), edge_weight=te[3] * 2.0)
    np.testing.assert_allclose(tpg._residuals(torch.from_numpy(xi), tg).numpy(),
                               np.asarray(jpg._residuals(jnp.asarray(xi), jg)), atol=1e-6)


def test_edge_jacobian_equals_full_jacfwd():
    """The per-edge Jacobian blocks, placed, equal ``jacfwd`` of the whole
    residual stack (the form JAX differentiates) within 1e-5, with a
    zero-weight self-edge as ``close_loops`` pads with."""
    _, est = _drifting_loop(8, [0.3, 0, 0.02, 0.01, 0.25, 0], [0.31, 0.01, 0.02, 0.01, 0.26, 0.005])
    poses = torch.tensor(est, dtype=torch.float32)
    i, j, Z, w = tpg.chain_edges(poses)
    Z = tpg.lie.mm_small(Z, tpg.lie.se3_exp(torch.tensor([0.01, -0.02, 0, 0.005, 0, 0.01])))
    g = tpg.PoseGraph(poses=poses, edge_i=torch.cat([i, torch.tensor([0, 7, 0])]),
                      edge_j=torch.cat([j, torch.tensor([7, 2, 0])]),
                      edge_T=torch.cat([Z, tpg._relative(poses[[0, 7]], poses[[7, 2]]), torch.eye(4)[None]]),
                      edge_weight=torch.cat([w, torch.tensor([5.0, 5.0, 0.0])]))
    full = torch.func.jacfwd(lambda x: tpg._residuals(x.reshape(8, 6), g))(torch.zeros(48))
    torch.testing.assert_close(tpg._jacobian(g), full.to(torch.float32), atol=1e-5, rtol=0)
