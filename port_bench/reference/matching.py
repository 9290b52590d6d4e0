# Frozen copy of semantic_slam_master_tpu_torch/ops/matching.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Brute-force descriptor matching (port of ``ops/matching.py``):
Hamming distance of packed ORB descriptors as a +/-1 product,
``(256 - <sa, sb>) / 2``, exact in f32; cosine similarity of learned
float descriptors with f32 sums; mutual nearest neighbours with a
distance or similarity gate and an optional ratio test.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so
ties resolve alike; ``torch.amax`` splits the gradient of a tied maximum
evenly, as ``jnp.max`` does (``max(dim).values`` sends it all to one
index), which the trainer's calibration losses see through ``score``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .orb import NUM_BITS, to_signs

_NEG = -3.4e38


class Matches(NamedTuple):
    """idx2 (..., N) int64, valid (..., N) bool, score (..., N) float32."""

    idx2: torch.Tensor
    valid: torch.Tensor
    score: torch.Tensor

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) packed words -> (..., N, M) float32."""
    dot = to_signs(desc1) @ to_signs(desc2).transpose(-1, -2)
    return (NUM_BITS - dot) * 0.5


def cosine_similarity_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., N, D) x (..., M, D) -> (..., N, M) f32 similarity (the
    descriptors are L2-normalised by the refiner)."""
    return torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))


def _mutual_and_ratio(
    sim: torch.Tensor,
    valid1: torch.Tensor | None,
    valid2: torch.Tensor | None,
    ratio: float | None,
    min_score: float | None,
) -> Matches:
    """Mutual-NN / ratio logic over a similarity matrix (higher = better)."""
    neg = torch.full_like(sim, _NEG)
    if valid2 is not None:
        sim = torch.where(valid2[..., None, :], sim, neg)
    best2 = torch.argmax(sim, dim=-1)  # (..., N)
    best_val = torch.amax(sim, dim=-1)
    best1_of_col = torch.argmax(sim, dim=-2)  # (..., M)
    row_ids = torch.arange(sim.shape[-2], device=sim.device)
    ok = torch.gather(best1_of_col, -1, best2) == row_ids
    if valid1 is not None:
        ok = ok & valid1
    if min_score is not None:
        ok = ok & (best_val > min_score)
    if ratio is not None:
        cols = torch.arange(sim.shape[-1], device=sim.device)
        second = torch.amax(torch.where(cols == best2[..., None], neg, sim), dim=-1)
        ok = ok & (second < ratio * best_val)
    return Matches(idx2=best2, valid=ok, score=best_val)


def match_cosine(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    ratio: float | None = 0.9,
    min_similarity: float | None = None,
) -> Matches:
    """Mutual-NN + ratio matching of float descriptors (..., N/M, D)."""
    sim = cosine_similarity_matrix(desc1, desc2)
    return _mutual_and_ratio(sim, valid1, valid2, ratio, min_similarity)


def match_hamming(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    max_distance: float | None = 64.0,
) -> Matches:
    """Mutual-NN matching of packed ORB descriptors with a distance gate."""
    sim = -hamming_distance_matrix(desc1, desc2)
    min_score = -max_distance if max_distance is not None else None
    return _mutual_and_ratio(sim, valid1, valid2, None, min_score)


