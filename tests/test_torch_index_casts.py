"""Port parity: rounded, clamped pixel indices at non-finite and extreme
centres, against the JAX package on the CPU.

JAX casts ``jnp.round(v)`` to int32 before its clip, and XLA's conversion
saturates: +inf and values past the int32 range land on the clip's high
bound, -inf on its low one, and NaN becomes 0. The port's plain versions
clamp in float before the cast (``core/fixed.py::round_clip_xy``), as
its CUDA kernels do, and must give the same pixels. Every comparison is
exact. Covered: ``gather_patches``, its padded twin (against the Pallas
kernel in interpret mode), ``nearest_sample`` and the aligned gather's
``patch_centers``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu.ops import sampling as jsampling
from semantic_slam_master_tpu.ops.pallas import patches as ppatches
from semantic_slam_master_tpu_torch.core.fixed import round_clip_xy
from semantic_slam_master_tpu_torch.ops import sampling as tsampling
from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
from semantic_slam_master_tpu_torch.ops.kernels import patches as kpatch

H, W = 48, 64
EXTREMES = [np.inf, -np.inf, np.nan, 3e9, -3e9]
# Clamp bounds (x_lo, x_hi, y_lo, y_hi) of the four callers on an H x W frame.
BOUNDS = {
    "gather_patches": (10, W - 11, 10, H - 11),
    "gather_patches_padded": (15, W - 17, 15, H - 17),
    "nearest_sample": (0, W - 1, 0, H - 1),
    "patch_centers": (15, W - 18, 15, H - 17),
}


def _centers() -> np.ndarray:
    """(1, K, 2) centres: each extreme in x, in y and in both, every pair
    of extremes, and every caller's clamp edges with half-pixel ties."""
    mid = (W / 2, H / 2)
    pts = []
    for v in EXTREMES:
        pts += [(v, mid[1]), (mid[0], v), (v, v)]
        pts += [(v, u) for u in EXTREMES if u is not v]
    for x_lo, x_hi, y_lo, y_hi in BOUNDS.values():
        for dx in (-1.0, -0.5, 0.0, 0.5):
            pts += [(x_lo + dx, y_lo + dx), (x_hi - dx, y_hi - dx), (x_lo + dx, y_hi - dx)]
    return np.asarray(pts, np.float32)[None]


def _frame() -> np.ndarray:
    return np.random.default_rng(7).normal(size=(1, H, W)).astype(np.float32)


@pytest.mark.parametrize("value", EXTREMES + [0.5, 1.5, -0.5, 2.5e9, 17.5])
@pytest.mark.parametrize("bounds", list(BOUNDS.values()), ids=list(BOUNDS))
def test_round_clip_xy_matches_xla(value, bounds):
    x_lo, x_hi, y_lo, y_hi = bounds
    xy = np.array([[value, -value], [-value, value], [value, H / 2]], np.float32)
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(xy)).astype(jnp.int32),
                              jnp.array([x_lo, y_lo]), jnp.array([x_hi, y_hi])))
    got = round_clip_xy(torch.from_numpy(xy), (x_lo, y_lo), (x_hi, y_hi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fn", list(BOUNDS))
def test_non_finite_and_edge_centres_match_jax(fn):
    img, xy = _frame(), _centers()
    t_img, t_xy = torch.from_numpy(img), torch.from_numpy(xy)
    if fn == "gather_patches":
        ref = np.asarray(jsampling.gather_patches(jnp.asarray(img), jnp.asarray(xy), 10))
        got = tsampling.gather_patches(t_img, t_xy, 10).numpy()
    elif fn == "gather_patches_padded":
        ref = np.asarray(ppatches.gather_patches_pallas(jnp.asarray(img), jnp.asarray(xy), 15, interpret=True))
        got = kgather.gather_patches_padded(t_img, t_xy, 15).numpy()
    elif fn == "nearest_sample":
        ref = np.asarray(jsampling.nearest_sample(jnp.asarray(img), jnp.asarray(xy)))
        got = tsampling.nearest_sample(t_img, t_xy).numpy()
    else:
        ref = np.stack([np.asarray(c) for c in jorb._patch_centers(jnp.asarray(xy), H, W)])
        got = torch.stack(kpatch.patch_centers(t_xy, H, W)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
