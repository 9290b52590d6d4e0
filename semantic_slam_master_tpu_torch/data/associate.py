"""Timestamp association of TUM RGB-D streams (numpy copy of
``data/associate.py``): the ``timestamp filename`` listings, nearest
timestamps, and the file-level association of ``associate.py``'s CLI."""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def read_stamped_file_list(path: str | Path) -> List[Tuple[float, str]]:
    """``(timestamp, filename)`` rows of a TUM listing (rgb.txt, depth.txt),
    blank lines and ``#`` comments skipped."""
    out: List[Tuple[float, str]] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


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


def associate_file_lists(
    rgb_list: Sequence[Tuple[float, str]],
    depth_list: Sequence[Tuple[float, str]],
    max_difference: float = 0.02,
) -> List[Tuple[float, str, float, str]]:
    """Rows ``(rgb_time, rgb_file, depth_time, depth_file)`` of the
    associated frames of two listings."""
    pairs = associate_timestamps(
        [t for t, _ in rgb_list], [t for t, _ in depth_list], max_difference
    )
    return [
        (rgb_list[i][0], rgb_list[i][1], depth_list[j][0], depth_list[j][1])
        for i, j in pairs
    ]


def write_associations(
    associations: Sequence[Tuple[float, str, float, str]], path: str | Path
) -> None:
    with open(path, "w") as f:
        for rgb_t, rgb_f, depth_t, depth_f in associations:
            f.write(f"{rgb_t} {rgb_f} {depth_t} {depth_f}\n")
