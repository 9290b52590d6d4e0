"""Oriented-BRIEF (ORB) descriptors (port of ``ops/orb.py``).

The port keeps the JAX package's matmul-structured path for every frame
width: each keypoint's 32x32 quantised patch (keypoint at (15, 15)) comes
from ``kernels.patches.gather_aligned_patches`` — the CUDA kernel
``csrc/aligned_patches.cu`` on the card, its plain version on the CPU —
then one product against the per-bin difference-selection constants
gives I(b_t) - I(a_t) for all 30 steering bins, and each keypoint picks
its own bin. All intensities are exact integers <= 255, so the result is
bit-identical to the JAX package's ``describe_matmul`` and
``describe_gather``.

Packed descriptor words are int64 holding the uint32 bit patterns of the
JAX package (torch's uint32 has no shifts on the CPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .kernels.patches import gather_aligned_patches

PATCH_RADIUS = 15  # ORB's 31x31 patch
NUM_BITS = 256
NUM_WORDS = NUM_BITS // 32
NUM_ANGLE_BINS = 30  # ORB discretizes steering to 2*pi/30


def make_test_pattern(seed: int = 7) -> np.ndarray:
    """(256, 4) int8 BRIEF test pairs (x_a, y_a, x_b, y_b): Gaussian
    (0, (patch/5)^2) samples clipped to a radius-13 box. Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(NUM_BITS, 4))
    max_r = PATCH_RADIUS - 2
    pts = np.clip(pts, -max_r / np.sqrt(2), max_r / np.sqrt(2))
    return np.round(pts).astype(np.int8)


def _steered_pattern_bank(pattern: np.ndarray) -> np.ndarray:
    """(NUM_ANGLE_BINS, 256, 4) float32 rotated test offsets, rounded once
    per bin as ORB does."""
    bank = np.zeros((NUM_ANGLE_BINS, NUM_BITS, 4), dtype=np.float32)
    for b in range(NUM_ANGLE_BINS):
        theta = 2.0 * np.pi * b / NUM_ANGLE_BINS
        c, s = np.cos(theta), np.sin(theta)
        xa, ya, xb, yb = pattern[:, 0], pattern[:, 1], pattern[:, 2], pattern[:, 3]
        bank[b, :, 0] = np.round(c * xa - s * ya)
        bank[b, :, 1] = np.round(s * xa + c * ya)
        bank[b, :, 2] = np.round(c * xb - s * yb)
        bank[b, :, 3] = np.round(s * xb + c * yb)
    return bank


def _bin_select_matrices(bank: np.ndarray) -> np.ndarray:
    """D[b, t, p] = [p == pos_b(t)] - [p == pos_a(t)] over the row-major
    32x32 patch; shape (NUM_ANGLE_BINS, NUM_BITS, 1024) float32."""
    D = np.zeros((NUM_ANGLE_BINS, NUM_BITS, 32 * 32), dtype=np.float32)
    for b in range(NUM_ANGLE_BINS):
        for t in range(NUM_BITS):
            xa, ya, xb, yb = bank[b, t].astype(int)
            D[b, t, (ya + PATCH_RADIUS) * 32 + (xa + PATCH_RADIUS)] -= 1.0
            D[b, t, (yb + PATCH_RADIUS) * 32 + (xb + PATCH_RADIUS)] += 1.0
    return D


def _orientation_weights() -> np.ndarray:
    """(961, 2) circular-disc x / y moment weights of the 31x31 patch."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    disc = (xs**2 + ys**2) <= r**2
    return np.stack([(xs * disc).ravel(), (ys * disc).ravel()], -1).astype(np.float32)


DEFAULT_PATTERN = make_test_pattern()


@functools.lru_cache(maxsize=8)
def _constants(pattern_bytes: bytes, device: str, dtype: torch.dtype):
    """(bin-select matrix (7680, 1024), moment weights (961, 2)) on device."""
    pattern = np.frombuffer(pattern_bytes, np.int8).reshape(NUM_BITS, 4)
    D = _bin_select_matrices(_steered_pattern_bank(pattern))
    sel = torch.from_numpy(D.reshape(-1, 32 * 32)).to(device=device, dtype=dtype)
    w = torch.from_numpy(_orientation_weights()).to(device)
    return sel, w


def orientations_from_patches(patches: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) of quantised (B, N, 31, 31)
    patches; integer moments < 2^24 are exact in f32 in any order."""
    B, N = patches.shape[:2]
    m = patches.reshape(B, N, -1).to(torch.float32) @ weights  # (B, N, 2)
    return torch.atan2(m[..., 1], m[..., 0])


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod``: fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def steered_bins(theta: torch.Tensor) -> torch.Tensor:
    """Steering bin in [0, 30) of each angle, as ``orb._steered_bins``."""
    two_pi = 2.0 * math.pi
    ang = _mod(theta, two_pi)
    bins = torch.clamp(torch.round(ang / (two_pi / NUM_ANGLE_BINS)).to(torch.int64), 0, NUM_ANGLE_BINS)
    return bins % NUM_ANGLE_BINS


def describe(
    img: torch.Tensor,
    xy: torch.Tensor,
    pattern: np.ndarray = DEFAULT_PATTERN,
) -> torch.Tensor:
    """rBRIEF descriptors of the prefiltered (blurred) frame.

    img: (B, H, W) f32 in [0, 1]; xy: (B, N, 2) f32. Returns packed
    (B, N, 8) int64 words (bit i of word w = test w*32 + i). The
    orientation is the intensity centroid of each quantised patch.
    """
    patches = gather_aligned_patches(img, xy)  # (B, N, 32, 32) bf16
    return describe_from_aligned(patches, pattern)


def describe_from_aligned(
    patches: torch.Tensor, pattern: np.ndarray = DEFAULT_PATTERN
) -> torch.Tensor:
    """All-bin difference tests on quantised (B, N, 32, 32) patches, then
    each keypoint's own bin. The product is exact: every row of the
    selection matrix holds one +1 and one -1, intensities are integers
    <= 255, and bf16 (on the card) or f32 (on the CPU) holds every
    difference exactly."""
    B, N = patches.shape[:2]
    dev = patches.device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    sel_mat, weights = _constants(np.ascontiguousarray(pattern, np.int8).tobytes(), str(dev), dtype)
    theta = orientations_from_patches(patches[..., :31, :31], weights)
    bins = steered_bins(theta)  # (B, N)
    diff = patches.reshape(B, N, 32 * 32).to(dtype) @ sel_mat.T  # (B, N, 7680)
    diff = diff.reshape(B, N, NUM_ANGLE_BINS, NUM_BITS)
    idx = bins[..., None, None].expand(B, N, 1, NUM_BITS)
    picked = torch.gather(diff, 2, idx)[:, :, 0]  # (B, N, 256)
    return pack_bits(picked > 0)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool/{0,1} -> packed (..., 8) int64 words."""
    words = bits.reshape(*bits.shape[:-1], NUM_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return torch.sum(words << shifts, dim=-1)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """Packed (..., 8) int words -> (..., 256) {0,1} int64 bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], NUM_BITS)


def to_signs(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed descriptors -> +/-1 vectors (..., 256)."""
    return (2 * unpack_bits(desc) - 1).to(dtype)
