"""Match plots (port of ``viz/matches.py``): two frames side by side with
lines coloured by similarity, and a multi-spacing grid anchored at frame
0, with the sequence matcher's combined quality (0.7 descriptor
similarity + 0.3 saliency) and its filters.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

QUALITY_DESC_WEIGHT = 0.7  # reference `visualize_matches_sequence.py:189-193`
QUALITY_SALIENCY_WEIGHT = 0.3


def combined_quality(desc_sim: np.ndarray, saliency: np.ndarray) -> np.ndarray:
    return QUALITY_DESC_WEIGHT * desc_sim + QUALITY_SALIENCY_WEIGHT * saliency


def filter_matches(
    desc_sim: np.ndarray,
    saliency1: np.ndarray,
    min_similarity: float = 0.5,
    min_saliency: float = 0.1,
) -> np.ndarray:
    """The sequence visualizer's quality filters (`:166-176`)."""
    return (desc_sim >= min_similarity) & (saliency1 >= min_saliency)


def draw_matches(
    rgb1: np.ndarray,
    rgb2: np.ndarray,
    kpts1: np.ndarray,
    kpts2: np.ndarray,
    matches: np.ndarray,
    similarities: Optional[np.ndarray] = None,
    output_path: str | Path = "matches.png",
    title: str = "matches",
    max_draw: int = 200,
) -> None:
    """Side-by-side match plot, line color = similarity (viridis)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rgb1, rgb2 = np.asarray(rgb1), np.asarray(rgb2)
    H = max(rgb1.shape[0], rgb2.shape[0])
    canvas = np.zeros((H, rgb1.shape[1] + rgb2.shape[1], 3), dtype=rgb1.dtype)
    canvas[: rgb1.shape[0], : rgb1.shape[1]] = rgb1
    canvas[: rgb2.shape[0], rgb1.shape[1] :] = rgb2
    xoff = rgb1.shape[1]

    fig, ax = plt.subplots(figsize=(16, 6))
    ax.imshow(canvas)
    matches = np.asarray(matches)[:max_draw]
    sims = (
        np.asarray(similarities)[:max_draw]
        if similarities is not None
        else np.ones(len(matches))
    )
    cmap = plt.get_cmap("viridis")
    for (i, j), s in zip(matches, sims):
        p1 = kpts1[int(i)]
        p2 = kpts2[int(j)]
        ax.plot(
            [p1[0], p2[0] + xoff], [p1[1], p2[1]],
            color=cmap(float(np.clip(s, 0, 1))), linewidth=0.7, alpha=0.8,
        )
    ax.scatter(kpts1[:, 0], kpts1[:, 1], s=3, c="red")
    ax.scatter(kpts2[:, 0] + xoff, kpts2[:, 1], s=3, c="red")
    ax.set_title(f"{title} ({len(matches)} matches)")
    ax.axis("off")
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def sequence_match_grid(
    frames: Sequence[np.ndarray],
    extract_and_match,
    spacings: Sequence[int] = (1, 5, 10, 15, 20),
    output_path: str | Path = "matches_sequence.png",
) -> Dict[int, int]:
    """Multi-spacing match panel: one row per spacing, anchored at frame 0.

    ``extract_and_match(rgb_a, rgb_b)`` returns (kpts1, kpts2, matches,
    similarities). Returns {spacing: num_matches}.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    usable = [s for s in spacings if s < len(frames)]
    fig, axes = plt.subplots(len(usable), 1, figsize=(14, 4 * len(usable)))
    if len(usable) == 1:
        axes = [axes]
    counts: Dict[int, int] = {}
    for ax, s in zip(axes, usable):
        k1, k2, m, sims = extract_and_match(frames[0], frames[s])
        rgb1, rgb2 = np.asarray(frames[0]), np.asarray(frames[s])
        canvas = np.concatenate([rgb1, rgb2], axis=1)
        xoff = rgb1.shape[1]
        ax.imshow(canvas)
        for (i, j), sim in zip(np.asarray(m)[:150], np.asarray(sims)[:150]):
            ax.plot(
                [k1[int(i)][0], k2[int(j)][0] + xoff],
                [k1[int(i)][1], k2[int(j)][1]],
                linewidth=0.6, alpha=0.7,
                color=plt.get_cmap("viridis")(float(np.clip(sim, 0, 1))),
            )
        counts[s] = len(m)
        ax.set_title(f"spacing {s}: {len(m)} matches")
        ax.axis("off")
    fig.tight_layout()
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=110)
    plt.close(fig)
    return counts
