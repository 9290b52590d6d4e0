"""The yardstick's byte, operation and FLOP counts against hand counts at
small shapes."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH)]

from harness import counters  # noqa: E402


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert counters.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counters.bound_s(0.0, counters.F32_OPS_PER_S) == pytest.approx(1.0)
    assert counters.bound_s(3.35e12, 2 * counters.F32_OPS_PER_S) == pytest.approx(2.0)


def test_fast_score_bound_by_hand():
    # 100 pixels, 10 pass the early test: 800 bytes; 100 x 12 + 10 x 163 operations.
    ops = 100 * 12 + 10 * 163
    assert counters.fast_score_bound_s(100, 10) == pytest.approx(max(800 / 3.35e12, ops / counters.F32_OPS_PER_S))


def test_unique_pixels_counts_overlap_once():
    idx = torch.tensor([[0, 1, 1, 2, 2, 2], [5, 5, 5, 5, 5, 5]])
    assert counters.unique_pixels(idx, 8) == 4


def test_aligned_patches_bound_by_hand():
    img = torch.zeros((1, 64, 64))
    # Two keypoints whose 32x32 windows overlap in 16 columns: 32 x 48 distinct pixels.
    xy = torch.tensor([[[20.0, 20.0], [36.0, 20.0]]])
    nbytes = 32 * 48 * 4 + 2 * (8 + 32 * 32 * 2)
    ops = 2 * 32 * 32 * 4
    assert counters.aligned_patches_bound_s(img, xy) == pytest.approx(counters.bound_s(nbytes, ops))
    # Keypoints beyond the frame clamp to the same window: read once.
    far = torch.tensor([[[-50.0, -50.0], [0.0, 0.0]]])
    nbytes = 32 * 32 * 4 + 2 * (8 + 32 * 32 * 2)
    assert counters.aligned_patches_bound_s(img, far) == pytest.approx(counters.bound_s(nbytes, ops))


def test_gather_patches_bound_by_hand():
    # 2 frames x 3 windows of side 21 on a 16-pixel grid.
    per = 16 * 16 * 4 + 21 * 21 * 4 + 8
    assert counters.gather_patches_bound_s(2, 3, 10, 16) == pytest.approx(2 * 3 * per / 3.35e12)


def test_vit_flops_by_hand():
    # 32x32 image, 16-px patches: 4 patches + cls + 1 register = 6 tokens, d 8, 2 heads, mlp 2x.
    t, d, h = 6, 8, 16
    block = 2 * t * d * 3 * d + 2 * (2 * t * t * d) + 2 * t * d * d + 2 * t * d * h + 2 * t * h * d
    embed = 2 * 4 * (16 * 16 * 3) * d
    assert counters.vit_flops(32, 32, d, 3, 2, 16, 1, 2.0) == embed + 3 * block


def test_segmenter_flops_by_hand():
    w, c = 8, 6
    p2, p4, p8 = 4 * 4, 2 * 2, 1 * 1  # an 8x8 frame
    want = (2 * p2 * 3 * w * 9 + 2 * p4 * w * 2 * w * 9 + 2 * p8 * 2 * w * 4 * w * 9
            + 2 * 2 * p8 * 4 * w * 4 * w * 9 + 2 * p4 * 6 * w * 2 * w * 9 + 2 * p4 * 2 * w * c)
    assert counters.segmenter_flops(8, 8, w, c) == want


def test_heads_flops_by_hand():
    # 32x32 image, 16-px patches -> 4 patches; 2 keypoints; no sub-patch refinement.
    e, sh, rh, rl, dd, eh, k = 8, 4, 6, 3, 5, 4, 2
    want = 2 * 4 * e * sh * 9 + 2 * 4 * sh
    want += 2 * k * e * rh + (rl - 2) * 2 * (2 * k * rh * rh) + 2 * k * rh * dd
    want += 2 * k * (e + dd) * eh + 2 * k * eh * (eh // 2) + 2 * k * (eh // 2)
    assert counters.heads_flops(32, 32, e, 16, sh, rh, rl, dd, eh, k, False) == want
    side = 2 * (16 // 2 + 2) + 1
    px = k * side * side
    refine = 2 * k * (e + 9) * 16 + 2 * px * 16 * 9 + 2 * px * 16 * 16 * 9 + 2 * px * 16 * 9
    assert counters.heads_flops(32, 32, e, 16, sh, rh, rl, dd, eh, k, True) == want + refine


def test_model_flops_of_the_configurations():
    orb = json.loads((BENCH / "configs" / "orb_tum640.json").read_text())
    assert counters.model_flops_per_frame(orb) == 0
    vits = json.loads((BENCH / "configs" / "vits16_sem.json").read_text())
    flops = counters.model_flops_per_frame(vits)
    # ViT-S/16 at 1205 tokens is about 78.6 GFLOP; heads and segmenter add about 13.
    assert 85e9 < flops < 100e9
