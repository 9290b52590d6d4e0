"""Timestamp association (numpy copy of ``data/associate.py``'s
``nearest_indices`` and ``associate_timestamps``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def nearest_indices(query_times: np.ndarray, ref_times: np.ndarray) -> np.ndarray:
    """For each query time, the index of the nearest (sorted) reference time."""
    ref_times = np.asarray(ref_times, dtype=np.float64)
    query_times = np.asarray(query_times, dtype=np.float64)
    pos = np.searchsorted(ref_times, query_times)
    left = np.clip(pos - 1, 0, len(ref_times) - 1)
    right = np.clip(pos, 0, len(ref_times) - 1)
    pick_right = np.abs(ref_times[right] - query_times) < np.abs(
        ref_times[left] - query_times
    )
    return np.where(pick_right, right, left)


def associate_timestamps(
    times_a: Sequence[float],
    times_b: Sequence[float],
    max_difference: float = 0.02,
) -> List[Tuple[int, int]]:
    """(index_a, index_b) pairs of two time-sorted streams whose nearest
    timestamps differ by less than ``max_difference``, with monotone b."""
    a = np.asarray(times_a, dtype=np.float64)
    b = np.asarray(times_b, dtype=np.float64)
    if len(a) == 0 or len(b) == 0:
        return []
    idx_b = nearest_indices(a, b)
    dt = np.abs(b[idx_b] - a)
    pairs = [(int(i), int(j)) for i, (j, d) in enumerate(zip(idx_b, dt)) if d < max_difference]
    out: List[Tuple[int, int]] = []
    last_b = -1
    for i, j in pairs:
        if j >= last_b:
            out.append((i, j))
            last_b = j
    return out
