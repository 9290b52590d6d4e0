"""TUM-format trajectory IO: ``timestamp tx ty tz qx qy qz qw`` lines
(port of ``data/trajectory_io.py``; rotations convert in float32, rounded
as the JAX package rounds them)."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..core import lie


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c of float32 arrays with one rounding to float32: the product
    is exact in float64, and the sum rounds there first (a double rounding
    that differs from a true fused multiply-add only on exact ties)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def quat_to_matrix_f32(q: np.ndarray) -> np.ndarray:
    """(N, 4) TUM-order quaternions (qx, qy, qz, qw) -> (N, 3, 3) float32
    rotations, rounded as the JAX package's ``lie.quat_to_matrix`` rounds
    them when called eagerly on float32: the norm is XLA's fused chain
    sqrt(fma(w, w, fma(z, z, fma(y, y, x * x)))), every other operation is
    one float32 operation."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q.T
    norm = np.sqrt(_fma32(w, w, _fma32(z, z, _fma32(y, y, x * x))))
    x, y, z, w = (q / np.maximum(norm, np.float32(1e-8))[:, None]).T
    rows = [
        [1 - 2 * (y**2 + z**2), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x**2 + z**2), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x**2 + y**2)],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def write_tum_trajectory(path: str | Path, timestamps: np.ndarray, poses: np.ndarray) -> None:
    """Write world-frame camera poses (N, 4, 4) as a TUM trajectory file."""
    poses = np.asarray(poses)
    rots = torch.from_numpy(poses[:, :3, :3].astype(np.float32))
    quats = lie.matrix_to_quat(rots).numpy()
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ts, T, q in zip(np.asarray(timestamps), poses, quats):
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_tum_trajectory(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (timestamps (N,), poses (N, 4, 4))."""
    times, mats = [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = quat_to_matrix_f32(np.array([[qx, qy, qz, qw]]))[0]
            T[:3, 3] = [tx, ty, tz]
            times.append(ts)
            mats.append(T)
    return np.asarray(times, dtype=np.float64), np.asarray(mats, dtype=np.float64)
