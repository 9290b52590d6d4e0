"""Port parity: Hamming matching of semantic_slam_master_tpu_torch
against the JAX package on the CPU (identical index pairs and masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.ops import matching as jmatching
from semantic_slam_master_tpu_torch.ops import matching as tmatching


def _t(x):
    return torch.from_numpy(np.array(x))


def _descs(seed, n=96, m=128, flip=0.08):
    """desc2 = a permutation of desc1 with a share of bits flipped, plus
    unrelated rows and exact duplicates (ties in argmax)."""
    rng = np.random.default_rng(seed)
    bits1 = rng.integers(0, 2, size=(n, 256)).astype(np.uint32)
    perm = rng.permutation(m)
    bits2 = rng.integers(0, 2, size=(m, 256)).astype(np.uint32)
    bits2[perm[:n]] = bits1 ^ (rng.random((n, 256)) < flip).astype(np.uint32)
    bits2[perm[n : n + 4]] = bits2[perm[:4]]  # duplicate columns
    pack = lambda b: (b.reshape(-1, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    valid1 = rng.random(n) < 0.9
    valid2 = rng.random(m) < 0.9
    return pack(bits1), pack(bits2), valid1, valid2


def test_hamming_matrix_exact():
    d1, d2, _, _ = _descs(0)
    ref = np.asarray(jmatching.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = tmatching.hamming_distance_matrix(_t(d1.astype(np.int64)), _t(d2.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_distance", [64.0, 100.0, None])
@pytest.mark.parametrize("use_valid", [True, False])
def test_match_hamming_identical(seed, max_distance, use_valid):
    d1, d2, v1, v2 = _descs(seed)
    jv1, jv2 = (jnp.asarray(v1), jnp.asarray(v2)) if use_valid else (None, None)
    tv1, tv2 = (_t(v1), _t(v2)) if use_valid else (None, None)
    ref = jmatching.match_hamming(jnp.asarray(d1), jnp.asarray(d2), jv1, jv2, max_distance=max_distance)
    got = tmatching.match_hamming(
        _t(d1.astype(np.int64)), _t(d2.astype(np.int64)), tv1, tv2, max_distance=max_distance
    )
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    assert int(got.count()) == int(ref.count())
    if max_distance == 64.0:
        assert int(got.count()) > 40


@pytest.mark.parametrize("ratio,min_score", [(0.9, None), (0.8, 0.1), (None, None)])
def test_mutual_and_ratio_identical(ratio, min_score):
    rng = np.random.default_rng(7)
    sim = np.round(rng.normal(size=(2, 40, 50)), 1).astype(np.float32)  # many ties
    v1 = rng.random((2, 40)) < 0.8
    v2 = rng.random((2, 50)) < 0.8
    ref = jmatching._mutual_and_ratio(jnp.asarray(sim), jnp.asarray(v1), jnp.asarray(v2), ratio, min_score)
    got = tmatching._mutual_and_ratio(_t(sim), _t(v1), _t(v2), ratio, min_score)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
