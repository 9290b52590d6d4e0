# Frozen copy of semantic_slam_master_tpu_torch/ops/orb.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Oriented-BRIEF (ORB) descriptors (port of ``ops/orb.py``).

Two paths give the JAX package's bits:

- the aligned path: each keypoint's 32x32 quantised patch (keypoint at
  (15, 15)) comes from ``kernels.patches.gather_aligned_patches`` (the
  CUDA kernel ``csrc/aligned_patches.cu`` on the card, its plain version
  on the CPU), then one product against the per-bin difference-selection
  constants gives I(b_t) - I(a_t) for all 30 steering bins, and each
  keypoint picks its own bin;
- the gather path (``describe_gather``): dense disc-moment maps for the
  orientation, then one flat gather of the 512 test points per keypoint.

All intensities are exact integers <= 255, so both are bit-identical to
the JAX package's ``describe_matmul`` and ``describe_gather`` wherever the
clamped patch centres leave the 31x31 disc inside the frame (frames of at
least 32 rows and 33 columns). ``describe`` takes the aligned path there
and copies JAX's own paths on smaller frames (see its docstring).

Packed descriptor words are int64 holding the uint32 bit patterns of the
JAX package (torch's uint32 has no shifts on the CPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .image import gaussian_blur, shift2d
from .fixed import round_clip_xy
from .sampling import nearest_sample

PATCH = 32
RADIUS = 15


def patch_centers(xy: torch.Tensor, H: int, W: int):
    """Clamped integer patch centres: cx in [15, W-18], cy in [15, H-17]
    (``ops/orb.py::_patch_centers``, non-finite xy included)."""
    c = round_clip_xy(xy, (RADIUS, RADIUS), (W - 18, H - 17))
    return c[..., 0], c[..., 1]


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] intensities -> the 0..255 integer grid (float carrier),
    rounding half to even (``ops/orb.py::_quantize_u8``)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0)


def gather_aligned_patches_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) f32, xy (B, N, 2) f32 -> (B, N, 32, 32) bf16
    quantised patches, in plain PyTorch (one flat gather)."""
    B, H, W = img.shape
    N = xy.shape[1]
    cx, cy = patch_centers(xy, H, W)
    d = torch.arange(PATCH, device=img.device) - RADIUS
    rows = (cy[..., None, None] + d[:, None]) * W  # (B, N, 32, 1)
    idx = rows + cx[..., None, None] + d[None, :]  # (B, N, 32, 32)
    flat = quantize_u8(img).reshape(B, H * W)
    out = torch.gather(flat, 1, idx.reshape(B, N * PATCH * PATCH))
    return out.reshape(B, N, PATCH, PATCH).to(torch.bfloat16)


gather_aligned_patches = gather_aligned_patches_plain

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
_PATTERN = DEFAULT_PATTERN  # the pattern every describe path reads (``set_test_pattern``)


@functools.lru_cache(maxsize=8)
def _constants(pattern_bytes: bytes, device: str, dtype: torch.dtype):
    """(bin-select matrix (7680, 1024) in ``dtype``, moment weights (961, 2)
    f32, steered pattern bank (30, 256, 4) int64) on ``device``."""
    pattern = np.frombuffer(pattern_bytes, np.int8).reshape(NUM_BITS, 4)
    bank = _steered_pattern_bank(pattern)
    sel = torch.from_numpy(_bin_select_matrices(bank).reshape(-1, 32 * 32)).to(device=device, dtype=dtype)
    w = torch.from_numpy(_orientation_weights()).to(device)
    return sel, w, torch.from_numpy(bank.astype(np.int64)).to(device)


def _device_constants(device: torch.device):
    """``_constants`` of the current pattern on ``device`` (bf16 selection
    matrix on the card, f32 on the CPU)."""
    return _constants(_PATTERN.tobytes(), str(device), torch.float32)


def orientations_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) of (B, N, 31, 31) patches
    over the radius-15 disc. For quantised patches the integer moments
    (< 2^24) are exact in f32 in any order."""
    B, N = patches.shape[:2]
    weights = _device_constants(patches.device)[1]
    m = patches.reshape(B, N, -1).to(torch.float32) @ weights  # (B, N, 2)
    return torch.atan2(m[..., 1], m[..., 0])


def _disc_extents(radius: int) -> np.ndarray:
    """Half-width of the disc at each |dy| (ORB's umax table)."""
    dys = np.arange(0, radius + 1)
    return np.floor(np.sqrt(radius**2 - dys**2 + 1e-9)).astype(np.int32)


def dense_moment_maps(img: torch.Tensor, radius: int = PATCH_RADIUS):
    """Disc moment maps m10(x, y), m01(x, y) of (B, H, W) at every pixel,
    built as the JAX op builds them: cumulative horizontal sums per disc
    extent, then combined row by row, in the same order. Zero-padded
    borders: values within ``radius`` of the edge are not disc-exact.
    Returns (m10, m01), each (B, H, W)."""
    extents = _disc_extents(radius)
    need = set(int(e) for e in extents)
    T: dict = {}
    U: dict = {}
    t = img * 0.0
    u = img
    if 0 in need:
        T[0], U[0] = t, u
    for e in range(1, radius + 1):
        t = t + float(e) * (shift2d(img, 0, -e) - shift2d(img, 0, e))
        u = u + shift2d(img, 0, -e) + shift2d(img, 0, e)
        if e in need:
            T[e], U[e] = t, u
    m10 = T[int(extents[0])]
    m01 = U[int(extents[0])] * 0.0
    for dy in range(1, radius + 1):
        e = int(extents[dy])
        m10 = m10 + shift2d(T[e], -dy, 0) + shift2d(T[e], dy, 0)
        m01 = m01 + float(dy) * (shift2d(U[e], -dy, 0) - shift2d(U[e], dy, 0))
    return m10, m01


def orientations_dense(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Per-keypoint orientation sampled from the dense moment maps (equal
    to the patch orientation away from the borders)."""
    m10, m01 = dense_moment_maps(img)
    return torch.atan2(nearest_sample(m01, xy), nearest_sample(m10, xy))


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


def _steered_offsets(theta: torch.Tensor) -> torch.Tensor:
    """(B, N, 256, 4) int64 rotated test offsets of each keypoint's bin."""
    return _device_constants(theta.device)[2][steered_bins(theta)]


def describe(
    img: torch.Tensor,
    xy: torch.Tensor,
    theta: torch.Tensor | None = None,
    blur_sigma: float = 2.0,
    prefiltered: bool = False,
) -> torch.Tensor:
    """rBRIEF descriptors.

    img: (B, H, W) f32 gray in [0, 1], blurred here with ``blur_sigma``
    unless ``prefiltered``; xy: (B, N, 2) f32; theta: (B, N) radians, the
    intensity centroid of each quantised patch when None. Returns packed
    (B, N, 8) int64 words (bit i of word w = test w*32 + i).

    The JAX package dispatches on the width (``describe_matmul`` for
    widths that are multiples of 32 and at least 64, else
    ``describe_gather``); both give the same bits wherever the clamped
    centres keep the disc inside the frame. So here:

    - frames of at least 32x33 take the aligned path (the kernel), equal
      to either JAX path;
    - smaller frames that JAX sends to ``describe_matmul`` (H < 32, W a
      multiple of 32 and >= 64) take the aligned path on the frame with
      32 - H copies of its first row stacked on top: ``describe_matmul``
      clamps its row indices into the frame, which gives those rows, and
      the kernel's row clamp [15, 15] puts every centre where JAX's
      crossed clamp puts it;
    - every other frame takes ``describe_gather``, as in JAX.
    """
    if not prefiltered:
        img = gaussian_blur(img, sigma=blur_sigma, radius=3)
    B, H, W = img.shape
    if H >= PATCH and W >= PATCH + 1:
        return describe_from_aligned(gather_aligned_patches(img, xy), theta)
    if W % 32 == 0 and W >= 64:
        top = img[:, :1].expand(B, PATCH - H, W)
        padded = torch.cat([top, img], dim=1).contiguous()
        return describe_from_aligned(gather_aligned_patches(padded, xy), theta)
    return describe_gather(img, xy, theta, blur_sigma, prefiltered=True)


def describe_gather(
    img: torch.Tensor,
    xy: torch.Tensor,
    theta: torch.Tensor | None = None,
    blur_sigma: float = 2.0,
    prefiltered: bool = False,
) -> torch.Tensor:
    """rBRIEF through one flat gather of the 512 test points per keypoint
    from the quantised frame (``orb.describe_gather``); the orientation,
    when not given, comes from the dense moment maps of the quantised
    frame at the clamped centres.

    On a frame too small for the centre clamp a test point can fall
    outside the frame. The flat index is then read as
    ``jnp.take_along_axis`` reads it: a negative index counts once from
    the end, and one still out of range reads NaN, whose comparison gives
    bit 0."""
    if not prefiltered:
        img = gaussian_blur(img, sigma=blur_sigma, radius=3)
    B, H, W = img.shape
    N = xy.shape[1]
    # On a frame below 32x33 the centre clamp crosses and every centre lands
    # on its upper bound, as jnp.clip puts it.
    cx, cy = patch_centers(xy, H, W)
    q = quantize_u8(img)
    if theta is None:
        cxy = torch.stack([cx, cy], dim=-1).to(img.dtype)
        theta = orientations_dense(q, cxy)
    offs = _steered_offsets(theta)  # (B, N, 256, 4)
    ax = cx[..., None] + offs[..., 0]
    ay = cy[..., None] + offs[..., 1]
    bx = cx[..., None] + offs[..., 2]
    by = cy[..., None] + offs[..., 3]
    idx = torch.cat([(ay * W + ax).reshape(B, N * NUM_BITS), (by * W + bx).reshape(B, N * NUM_BITS)], dim=1)
    idx = torch.where(idx < 0, idx + H * W, idx)
    inside = (idx >= 0) & (idx < H * W)
    vals = torch.gather(q.reshape(B, H * W), 1, torch.where(inside, idx, torch.zeros_like(idx)))
    vals = torch.where(inside, vals, torch.full_like(vals, float("nan")))
    ia = vals[:, : N * NUM_BITS].reshape(B, N, NUM_BITS)
    ib = vals[:, N * NUM_BITS :].reshape(B, N, NUM_BITS)
    return pack_bits(ia < ib)


def describe_from_aligned(patches: torch.Tensor, theta: torch.Tensor | None = None) -> torch.Tensor:
    """All-bin difference tests on quantised (B, N, 32, 32) patches, then
    each keypoint's own bin (``theta``, else the intensity centroid of the
    31x31 window). The product is exact: every row of the selection
    matrix holds one +1 and one -1, intensities are integers <= 255, and
    bf16 (on the card) or f32 (on the CPU) holds every difference
    exactly."""
    B, N = patches.shape[:2]
    sel_mat, _, _ = _device_constants(patches.device)
    if theta is None:
        theta = orientations_from_patches(patches[..., :31, :31])
    bins = steered_bins(theta)  # (B, N)
    diff = patches.reshape(B, N, 32 * 32).to(sel_mat.dtype) @ sel_mat.T  # (B, N, 7680)
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
