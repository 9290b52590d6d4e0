"""The port's ``core/fixed.py`` helpers that only the JAX package's own
tests use (``masked_mean``, ``masked_var``, ``pad_axis_to``, ``finite_or``,
``round_up``), on ``tests/test_fixed.py``'s cases and a few more, against
the JAX functions: floats within 1e-7 relative (one f32 division apart at
most), everything else exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core import fixed as jfixed
from semantic_slam_master_tpu_torch.core import fixed as tfixed

X = np.array([1.0, 2.0, 3.0, 100.0], np.float32)
MASK = np.array([True, True, True, False])


@pytest.mark.parametrize("fn", ["masked_mean", "masked_var"])
def test_masked_mean_var(fn):
    got = getattr(tfixed, fn)(torch.from_numpy(X), torch.from_numpy(MASK))
    want = getattr(jfixed, fn)(jnp.asarray(X), jnp.asarray(MASK))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert np.isclose(float(got), {"masked_mean": 2.0, "masked_var": 2.0 / 3.0}[fn])


@pytest.mark.parametrize("axis", [0, 1])
def test_masked_mean_var_along_an_axis(axis):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    m = rng.random((5, 7)) < 0.6
    m[0] = False  # an all-masked row: the count is floored at eps
    for fn in ("masked_mean", "masked_var"):
        got = getattr(tfixed, fn)(torch.from_numpy(x), torch.from_numpy(m), dim=axis)
        want = getattr(jfixed, fn)(jnp.asarray(x), jnp.asarray(m), axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=fn)


def test_finite_or():
    x = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    got = tfixed.finite_or(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfixed.finite_or(jnp.asarray(x), 0.5)))
    np.testing.assert_array_equal(got, [1.0, 0.5, 0.5, 0.5])


@pytest.mark.parametrize("axis", [0, 1])
def test_pad_axis_to(axis):
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    got = tfixed.pad_axis_to(torch.from_numpy(x), 5, dim=axis, value=-1)
    want = np.asarray(jfixed.pad_axis_to(jnp.asarray(x), 5, axis=axis, value=-1))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    same = torch.from_numpy(x)
    assert tfixed.pad_axis_to(same, x.shape[axis], dim=axis) is same
    with pytest.raises(ValueError, match="already larger"):
        tfixed.pad_axis_to(torch.from_numpy(x), 1, dim=axis)


@pytest.mark.parametrize("x, multiple", [(500, 128), (128, 128), (0, 8), (1, 8), (129, 128)])
def test_round_up(x, multiple):
    assert tfixed.round_up(x, multiple) == jfixed.round_up(x, multiple)
