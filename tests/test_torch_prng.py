"""The port's numpy copy of JAX's default generator (``core/prng.py``)
bit for bit against ``jax.random`` on the CPU: keys, ``split`` and
``uniform`` at the seeds and sizes of a 60-frame ``run-slam``, a seed
past 32 bits, and ``slam_uniforms`` against the recipe the JAX
``run_slam`` follows."""

import warnings

import jax
import numpy as np
import pytest

from semantic_slam_master_tpu_torch.core import prng

FRAMES = 60
HYPOTHESES = 64


def _jax_key(seed):
    with warnings.catch_warnings():  # a seed past int32 warns of its truncation
        warnings.simplefilter("ignore")
        return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 - 1, -7, 123456789012])
def test_key_split_and_uniform_match_jax(seed):
    jkey = _jax_key(seed)
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    jkeys = np.asarray(jax.random.split(jkey, FRAMES))
    keys = prng.split(key, FRAMES)
    assert keys.dtype == np.uint32 and keys.shape == (FRAMES, 2)
    np.testing.assert_array_equal(keys, jkeys)
    for f in (1, 17, FRAMES - 1):
        u = prng.uniform(keys[f], (HYPOTHESES, 3))
        ju = np.asarray(jax.random.uniform(jax.random.split(jkey, FRAMES)[f], (HYPOTHESES, 3)))
        assert u.dtype == np.float32 and u.shape == (HYPOTHESES, 3)
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))


def test_uniform_matches_jax_at_odd_shapes():
    key = prng.split(prng.PRNGKey(5), 3)[2]
    for shape in [(1,), (7, 5), (2, 3, 11)]:
        ju = np.asarray(jax.random.uniform(np.asarray(key), shape))
        np.testing.assert_array_equal(prng.uniform(key, shape).view(np.uint32), ju.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_slam_uniforms_are_jax_run_slam_draws(seed):
    keys = jax.random.split(_jax_key(seed), FRAMES)
    want = [np.zeros((HYPOTHESES, 3), np.float32)] + [
        np.asarray(jax.random.uniform(k, (HYPOTHESES, 3))) for k in keys[1:]
    ]
    got = prng.slam_uniforms(seed, FRAMES, HYPOTHESES)
    np.testing.assert_array_equal(got.view(np.uint32), np.stack(want).view(np.uint32))
