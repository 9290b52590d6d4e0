"""Multi-run statistics for trajectory evaluation (numpy copy of
``eval/stats.py``): the n-run summary with a Student-t 95% interval, and
the paired two-sided Wilcoxon signed-rank test (exact null distribution
for n <= 12 non-zero differences, the tie-corrected normal approximation
beyond).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# Two-sided 97.5% Student-t quantiles for df = 1..30 (beyond: 1.96).
_T975 = [
    12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262, 2.228,
    2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101, 2.093, 2.086,
    2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052, 2.048, 2.045, 2.042,
]


def t_critical_975(df: int) -> float:
    if df < 1:
        return float("nan")
    return _T975[df - 1] if df <= len(_T975) else 1.96


def summarize(values: Sequence[float]) -> Dict[str, float]:
    """Mean / median / std (ddof=1) / half-width 95% CI of n runs."""
    v = np.asarray(list(values), dtype=np.float64)
    n = len(v)
    out = {
        "n": int(n),
        "mean": float(np.mean(v)),
        "median": float(np.median(v)),
        "min": float(np.min(v)),
        "max": float(np.max(v)),
    }
    if n >= 2:
        sd = float(np.std(v, ddof=1))
        out["std"] = sd
        out["ci95_half_width"] = float(
            t_critical_975(n - 1) * sd / np.sqrt(n)
        )
    return out


def wilcoxon_signed_rank(
    a: Sequence[float], b: Sequence[float]
) -> Dict[str, float]:
    """Two-sided paired Wilcoxon signed-rank test of a vs b.

    Zero differences are dropped (Wilcoxon's convention); tied |d| get
    midranks. For n <= 12 non-zero pairs the p-value is EXACT (all 2^n
    sign assignments enumerated); beyond, the tie-corrected normal
    approximation. Returns {statistic, p_value, n}; p_value = 1.0 when
    fewer than 2 informative pairs exist.
    """
    a = np.asarray(list(a), dtype=np.float64)
    b = np.asarray(list(b), dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = a - b
    d = d[d != 0.0]
    n = len(d)
    if n < 2:
        return {"statistic": 0.0, "p_value": 1.0, "n": int(n)}

    absd = np.abs(d)
    order = np.argsort(absd, kind="stable")
    ranks = np.empty(n, dtype=np.float64)
    sorted_abs = absd[order]
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sorted_abs[j + 1] == sorted_abs[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0  # midrank
        i = j + 1

    w_plus = float(np.sum(ranks[d > 0]))
    w_minus = float(np.sum(ranks[d < 0]))
    W = min(w_plus, w_minus)

    if n <= 12:
        # Exact: distribution of W+ over all sign assignments (ties kept
        # as midranks — enumeration handles them exactly).
        totals = np.zeros(1)
        for r in ranks:
            totals = np.concatenate([totals, totals + r])
        # two-sided: P(min(W+, W-) <= W) with W- = T - W+
        T = float(np.sum(ranks))
        wp = totals
        wm = T - totals
        p = float(np.mean(np.minimum(wp, wm) <= W + 1e-12))
        p = min(1.0, p)
    else:
        mean = n * (n + 1) / 4.0
        # tie correction on the variance
        _, counts = np.unique(absd, return_counts=True)
        tie_term = float(np.sum(counts**3 - counts)) / 48.0
        var = n * (n + 1) * (2 * n + 1) / 24.0 - tie_term
        z = (W - mean + 0.5) / np.sqrt(max(var, 1e-12))  # continuity corr.
        p = float(min(1.0, 2.0 * _norm_sf(abs(z))))
    return {"statistic": W, "p_value": p, "n": int(n)}


def _norm_sf(z: float) -> float:
    """Standard normal survival function via erfc."""
    import math

    return 0.5 * math.erfc(z / math.sqrt(2.0))
