"""Edge-aware saliency dashboard (port of ``viz/saliency.py``): a 9-panel
figure of keypoints over the image, the saliency map, the Sobel edge map,
overlays, an alignment-error map, histograms, the edge-saliency
correlation scatter, and a stats panel with the reference's target
ranges (mean 0.40-0.50, variance 0.18-0.28, correlation > 0.40).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _edge_map(rgb: np.ndarray) -> np.ndarray:
    """Sobel magnitude of the frame's luma, scaled to a maximum of 1 (on
    the CPU: a few small host-side convolutions)."""
    from ..ops.image import rgb_to_gray, sobel_magnitude

    gray = rgb_to_gray(torch.from_numpy(np.asarray(rgb, np.float32))[None])
    mag = sobel_magnitude(gray).numpy()[0]
    return mag / (mag.max() + 1e-8)


def saliency_dashboard(
    rgb: np.ndarray,
    saliency: np.ndarray,
    keypoints_px: Optional[np.ndarray] = None,
    output_path: str | Path = "saliency_analysis.png",
    title: str = "Edge-aware saliency analysis",
) -> Dict[str, float]:
    """Render the 9-panel dashboard; returns the stats it displays.

    rgb: (H, W, 3) [0, 1]; saliency: (h, w) patch-resolution map;
    keypoints_px: (N, 2) pixel coords or None.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb = np.asarray(rgb)
    sal = np.asarray(saliency)
    if sal.ndim == 3:
        sal = sal[..., 0]
    H, W = rgb.shape[:2]
    edge = _edge_map(rgb)
    # Pool edge map to saliency resolution for correlation (the loss's view)
    fh, fw = H // sal.shape[0], W // sal.shape[1]
    edge_small = edge[: sal.shape[0] * fh, : sal.shape[1] * fw].reshape(
        sal.shape[0], fh, sal.shape[1], fw
    ).mean(axis=(1, 3))

    ec = edge_small.ravel() - edge_small.mean()
    sc = sal.ravel() - sal.mean()
    corr = float(
        (ec * sc).sum() / (np.sqrt((ec**2).sum() * (sc**2).sum()) + 1e-8)
    )
    stats = {
        "mean_saliency": float(sal.mean()),
        "max_saliency": float(sal.max()),
        "saliency_variance": float(sal.var()),
        "edge_saliency_correlation": corr,
    }

    fig, axes = plt.subplots(3, 3, figsize=(15, 12))
    fig.suptitle(title)

    axes[0, 0].imshow(rgb)
    if keypoints_px is not None and len(keypoints_px):
        axes[0, 0].scatter(
            keypoints_px[:, 0], keypoints_px[:, 1], s=4, c="lime", alpha=0.7
        )
    axes[0, 0].set_title("image + keypoints")

    im1 = axes[0, 1].imshow(sal, cmap="viridis", vmin=0, vmax=1)
    axes[0, 1].set_title("saliency map")
    fig.colorbar(im1, ax=axes[0, 1], fraction=0.046)

    axes[0, 2].imshow(edge, cmap="gray")
    axes[0, 2].set_title("Sobel edge magnitude")

    axes[1, 0].imshow(rgb)
    axes[1, 0].imshow(
        np.kron(sal, np.ones((fh, fw)))[:H, :W], cmap="viridis", alpha=0.5
    )
    axes[1, 0].set_title("saliency overlay")

    axes[1, 1].imshow(edge_small, cmap="gray")
    axes[1, 1].set_title("edge map (pooled)")

    err = np.abs(sal - edge_small / (edge_small.max() + 1e-8))
    im5 = axes[1, 2].imshow(err, cmap="magma")
    axes[1, 2].set_title("|saliency - edges| alignment error")
    fig.colorbar(im5, ax=axes[1, 2], fraction=0.046)

    axes[2, 0].hist(sal.ravel(), bins=40, color="steelblue")
    axes[2, 0].set_title("saliency histogram")

    axes[2, 1].scatter(edge_small.ravel(), sal.ravel(), s=3, alpha=0.3)
    axes[2, 1].set_xlabel("edge strength")
    axes[2, 1].set_ylabel("saliency")
    axes[2, 1].set_title(f"edge-saliency corr = {corr:.3f}")

    axes[2, 2].axis("off")
    lines = [
        f"mean saliency     {stats['mean_saliency']:.3f}  (target 0.40-0.50)",
        f"saliency variance {stats['saliency_variance']:.3f}  (target 0.18-0.28)",
        f"edge correlation  {corr:.3f}  (target > 0.40)",
        f"max saliency      {stats['max_saliency']:.3f}",
    ]
    axes[2, 2].text(0.02, 0.8, "\n".join(lines), family="monospace", fontsize=11,
                    va="top")
    axes[2, 2].set_title("stats vs reference targets")

    fig.tight_layout()
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=120)
    plt.close(fig)
    return stats
