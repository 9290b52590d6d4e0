"""The acceptance suite's PNG dashboard (port of ``viz/test_dashboard.py``):
per sequence, repeatability and tracking bars per spacing against their
target lines, the descriptor-quality metrics, and the per-stage latency
with the fps.

Chart conventions: one measure per axis, a single recessive hue for
magnitude bars, targets as dashed neutral lines, and pass/fail stated in
text (never colour alone).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

BAR = "#4477aa"  # single categorical hue (magnitude bars)
TARGET = "#666666"  # neutral target line
PASS_INK = "#1b7837"
FAIL_INK = "#b2182b"
GRID = dict(axis="y", color="#dddddd", linewidth=0.6, zorder=0)


def _style(ax, title: str, ylim=None):
    ax.set_title(title, fontsize=10)
    ax.grid(**GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    if ylim:
        ax.set_ylim(*ylim)


def _bars_with_target(ax, names, values, target, label_target: str):
    x = np.arange(len(names))
    ax.bar(x, values, width=0.6, color=BAR, zorder=2)
    ax.axhline(target, color=TARGET, linestyle="--", linewidth=1.2, zorder=3)
    ax.text(
        0.99, target, f"target {label_target} ",
        va="bottom", ha="right", fontsize=8, color=TARGET,
        transform=ax.get_yaxis_transform(),
    )
    for xi, v in zip(x, values):
        ok = v >= target
        ax.text(
            xi, v, f"{v:.2f}\n{'PASS' if ok else 'FAIL'}",
            ha="center", va="bottom", fontsize=8,
            color=PASS_INK if ok else FAIL_INK,
        )
    ax.set_xticks(x)
    ax.set_xticklabels(names, fontsize=9)


def acceptance_dashboard(results: Dict, out_path, sequence: str = "") -> str:
    """Render one sequence's `run_all` result dict to a PNG.

    ``results`` is the dict returned by `eval.frontend_tests.run_all`:
    keys repeatability (list per spacing), descriptor_quality, tracking
    (list per spacing), optionally performance.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 7.5))
    fig.suptitle(
        f"Frontend acceptance — {sequence}" if sequence else "Frontend acceptance",
        fontsize=12,
    )

    # 1. repeatability per spacing
    ax = axes[0, 0]
    reps = results.get("repeatability", [])
    if reps:
        _bars_with_target(
            ax,
            [f"sp {r['spacing']}" for r in reps],
            [r["mean_repeatability"] for r in reps],
            reps[0]["target"],
            f"{reps[0]['target']:.2f}",
        )
    _style(ax, "Repeatability (within 3 px)", ylim=(0, 1.15))

    # 2. descriptor quality metrics
    ax = axes[0, 1]
    dq = results.get("descriptor_quality", {})
    if dq:
        names = ["precision", "recall", "f1", "inlier_ratio"]
        vals = [dq.get(k, 0.0) for k in names]
        x = np.arange(len(names))
        ax.bar(x, vals, width=0.6, color=BAR, zorder=2)
        # two targets: precision >= 0.70, inlier >= 0.80
        for idx, tgt in ((0, 0.70), (3, 0.80)):
            ax.plot(
                [idx - 0.38, idx + 0.38], [tgt, tgt],
                color=TARGET, linestyle="--", linewidth=1.2, zorder=3,
            )
        for xi, (name, v) in enumerate(zip(names, vals)):
            tgt = {0: 0.70, 3: 0.80}.get(xi)
            note = "" if tgt is None else ("\nPASS" if v >= tgt else "\nFAIL")
            ink = (
                "#333333" if tgt is None
                else (PASS_INK if v >= tgt else FAIL_INK)
            )
            ax.text(xi, v, f"{v:.2f}{note}", ha="center", va="bottom",
                    fontsize=8, color=ink)
        ax.set_xticks(x)
        ax.set_xticklabels(names, fontsize=9)
    _style(ax, "Descriptor quality (mutual-NN + ratio vs GT warp)",
           ylim=(0, 1.15))

    # 3. tracking success per spacing
    ax = axes[1, 0]
    trs = results.get("tracking", [])
    if trs:
        _bars_with_target(
            ax,
            [f"sp {t['spacing']}" for t in trs],
            [t["success_rate"] for t in trs],
            trs[0]["target"],
            f"{trs[0]['target']:.2f}",
        )
    _style(ax, "Tracking success (>=50 matches/step)", ylim=(0, 1.15))

    # 4. per-stage latency + FPS
    ax = axes[1, 1]
    perf = results.get("performance", {})
    stages = perf.get("stages", {}) if perf else {}
    stages = {k: v for k, v in stages.items() if k != "total"}
    if stages:
        names = list(stages)
        vals = [
            s["mean_ms"] if isinstance(s, dict) else float(s)
            for s in stages.values()
        ]
        y = np.arange(len(names))
        ax.barh(y, vals, height=0.6, color=BAR, zorder=2)
        for yi, v in zip(y, vals):
            ax.text(v, yi, f" {v:.2f} ms", va="center", fontsize=8,
                    color="#333333")
        ax.set_yticks(y)
        ax.set_yticklabels(names, fontsize=9)
        ax.invert_yaxis()
        ax.set_xlabel("latency (ms)", fontsize=9)
        title = "Per-stage latency"
        if "fps" in perf:
            title += f" — {perf['fps']:.1f} FPS"
        _style(ax, title)
        ax.grid(axis="x", color="#dddddd", linewidth=0.6, zorder=0)
    else:
        if perf and "fps" in perf:
            ax.text(0.5, 0.5, f"{perf['fps']:.1f} FPS", ha="center",
                    va="center", fontsize=22, color="#333333")
        _style(ax, "Performance")
        ax.set_xticks([])
        ax.set_yticks([])

    fig.tight_layout(rect=(0, 0, 1, 0.96))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return str(out_path)
