"""JAX's default random generator in numpy, bit for bit.

``jax.random`` with its default implementation (threefry2x32, with
``jax_threefry_partitionable`` on, the default since jax 0.5) written in
numpy uint32 arithmetic, so that the port draws the same numbers as the
JAX package from the same seed without importing JAX. A key is a (2,)
uint32 array; ``split`` and ``uniform`` take one key, ``threefry2x32``
also a batch of keys (..., 2) that broadcasts against the counters.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``, as ``jax._src.prng.threefry2x32``."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is
    wrapped to int32, its high word (0) and low word make the key."""
    low = np.int64(seed).astype(np.int32).view(np.uint32)
    return np.array([0, low], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat index 0..n-1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _counters(num)
    return np.stack(threefry2x32(key, hi, lo), axis=-1)


def _uniform(keys: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` for each key k of ``keys`` (..., 2):
    float32 in [0, 1), the top 23 bits of each 32-bit draw as the mantissa
    of a float in [1, 2), less 1."""
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(np.asarray(keys, np.uint32)[..., None, :], hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats).reshape(*np.shape(keys)[:-1], *shape)


def uniform(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    return _uniform(key, shape)


def slam_uniforms(seed: int, num_frames: int, num_hypotheses: int) -> np.ndarray:
    """(F, H, 3) float32 RANSAC uniforms of the JAX ``run_slam`` for
    ``PRNGKey(seed)`` (:func:`key_slam_uniforms`)."""
    return key_slam_uniforms(PRNGKey(seed), num_frames, num_hypotheses)


def key_slam_uniforms(key: np.ndarray, num_frames: int, num_hypotheses: int) -> np.ndarray:
    """(F, H, 3) float32 RANSAC uniforms of the JAX ``run_slam`` for
    ``key``: it splits the key into one per frame, and frame f > 0 draws
    ``uniform(keys[f], (H, 3))`` (frame 0 bootstraps the map and draws
    nothing, so its row is zeros)."""
    keys = split(np.asarray(key, np.uint32), num_frames)
    out = np.zeros((num_frames, num_hypotheses, 3), np.float32)
    out[1:] = _uniform(keys[1:], (num_hypotheses, 3))
    return out
