"""3-D trajectory comparison plot (port of ``viz/trajectory.py``): ground
truth dashed black, the estimate solid blue after its SE(3) alignment."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..eval.ate_rpe import umeyama_alignment


def plot_trajectory_comparison(
    poses_gt: np.ndarray,
    poses_est: np.ndarray,
    output_path: str | Path,
    title: str = "trajectory",
    est_label: str = "estimate",
) -> None:
    """Write the aligned estimate over the ground truth, (F, 4, 4) poses
    each, to ``output_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p_gt = np.asarray(poses_gt)[:, :3, 3]
    p_est = np.asarray(poses_est)[:, :3, 3]
    R, t, s = umeyama_alignment(p_est, p_gt, with_scale=False)
    p_al = (s * (R @ p_est.T)).T + t

    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(p_gt[:, 0], p_gt[:, 1], p_gt[:, 2], "--", color="black",
            alpha=0.5, linewidth=2, label="Ground Truth")
    ax.plot(p_al[:, 0], p_al[:, 1], p_al[:, 2], "-", color="blue",
            linewidth=2, label=est_label)
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    ax.set_zlabel("Z [m]")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
