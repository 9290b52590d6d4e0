"""FAST-9 corner response: CUDA kernel wrapper and its plain version.

Counterpart of the TPU kernel ``ops/pallas/fast_score.py::
fast_score_pallas``; the kernel is ``csrc/fast_score.cu``. Both versions
read neighbours outside the frame as 0 and accumulate the margins in
circle order, so on the card they agree bit for bit. ``fast_candidates_plain``
states the kernel's 4-point early test in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER_MARGIN = 3


def _arc9(word: torch.Tensor) -> torch.Tensor:
    """Nonzero where any 9 circularly contiguous of the 16 bits are set."""
    d = word | (word << 16)
    c3 = d & (d >> 1) & (d >> 2)
    c9 = c3 & (c3 >> 3) & (c3 >> 6)
    return (c9 & 0xFFFF) != 0


def fast_score_plain(gray: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """(B, H, W) f32 in [0, 1] -> (B, H, W) f32 FAST-9 response, in plain
    PyTorch: a loop over the 16 circle points in the kernel's order."""
    B, H, W = gray.shape
    r = BORDER_MARGIN
    padded = F.pad(gray, (r, r, r, r))
    word_b = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    word_d = torch.zeros_like(word_b)
    bright = torch.zeros_like(gray)
    dark = torch.zeros_like(gray)
    for i, (dy, dx) in enumerate(FAST_CIRCLE):
        diff = padded[:, r + dy : r + dy + H, r + dx : r + dx + W] - gray
        word_b |= (diff > threshold).to(torch.int64) << i
        word_d |= (diff < -threshold).to(torch.int64) << i
        bright = bright + torch.clamp(diff - threshold, min=0.0)
        dark = dark + torch.clamp(-diff - threshold, min=0.0)
    is_b = _arc9(word_b)
    is_d = _arc9(word_d)
    zero = torch.zeros_like(gray)
    score = torch.where(is_b, bright, zero) + torch.where(is_d, dark, zero)
    return torch.where(is_b | is_d, score, zero)


def fast_candidates_plain(gray: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """(B, H, W) bool: the pixels that pass the kernel's 4-point test, in
    plain PyTorch. Any arc of 9 of the 16 circle points holds two
    circularly adjacent compass points (circle indices 0, 4, 8, 12) of its
    polarity, so a pixel outside this mask has a response of exactly 0 and
    the kernel skips its 16-point chain."""
    B, H, W = gray.shape
    r = BORDER_MARGIN
    padded = F.pad(gray, (r, r, r, r))
    diffs = [padded[:, r + dy : r + dy + H, r + dx : r + dx + W] - gray for dy, dx in FAST_CIRCLE[::4]]

    def adjacent_pair(bits):  # (b0 & b4) | (b4 & b8) | (b8 & b12) | (b12 & b0)
        return (bits[0] | bits[2]) & (bits[1] | bits[3])

    return adjacent_pair([d > threshold for d in diffs]) | adjacent_pair([d < -threshold for d in diffs])


def _check(gray: torch.Tensor) -> None:
    if gray.ndim != 3:
        raise ValueError(f"fast_score expects (B, H, W), got {tuple(gray.shape)}")
    if gray.dtype != torch.float32:
        raise TypeError(f"fast_score expects float32, got {gray.dtype}")


def fast_score(gray: torch.Tensor, threshold: float = 0.08) -> torch.Tensor:
    """FAST-9 response of (B, H, W) float32: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check(gray)
    if gray.device.type == "cpu":
        return fast_score_plain(gray, threshold)
    if gray.device.type != "cuda":
        raise ValueError(f"fast_score: unsupported device {gray.device}")
    from . import build

    gray = gray.contiguous()
    B, H, W = gray.shape
    out = torch.empty_like(gray)
    stream = torch.cuda.current_stream(gray.device).cuda_stream
    status = build.library().semslam_fast_score(
        gray.data_ptr(), out.data_ptr(), B, H, W, float(threshold), stream
    )
    build.check(status, "semslam_fast_score")
    fast_score.launches += 1
    return out


fast_score.launches = 0
