"""TUM-format trajectory IO: ``timestamp tx ty tz qx qy qz qw`` lines
(port of ``data/trajectory_io.py``; rotations convert in float32 as the
JAX package's do)."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..core import lie


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
            R = lie.quat_to_matrix(torch.tensor([qx, qy, qz, qw], dtype=torch.float32))
            T = np.eye(4)
            T[:3, :3] = R.numpy()
            T[:3, 3] = [tx, ty, tz]
            times.append(ts)
            mats.append(T)
    return np.asarray(times, dtype=np.float64), np.asarray(mats, dtype=np.float64)
