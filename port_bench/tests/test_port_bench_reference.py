"""The frozen reference against the port's plain path it was copied from,
on the CPU: the learned frontend and the segmenter at float32 give the
same numbers from the same committed weights, and the fp8 control does
not."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from reference import frontend as ref_frontend  # noqa: E402
from reference import segmenter as ref_segmenter  # noqa: E402
from reference import weights as ref_weights  # noqa: E402
from reference.layers import FP8, cast  # noqa: E402
from semantic_slam_master_tpu_torch import convert  # noqa: E402
from semantic_slam_master_tpu_torch.models import frontend as port_frontend  # noqa: E402
from semantic_slam_master_tpu_torch.models import segmenter as port_segmenter  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "vits16_sem.json").read_text())


def _images(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g)


def _frontends(dtype):
    sizes = dict(CONFIG["model"]["sizes"], num_keypoints=24)
    path = str(ROOT / CONFIG["model"]["checkpoint"])
    port = port_frontend.LearnedFrontend(**sizes, dtype=torch.float32)
    port.load_state_dict(convert.frontend_state_dict(path))
    ref = ref_frontend.LearnedFrontend(**sizes, dtype=dtype)
    ref.load_state_dict(ref_weights.frontend_state_dict(path))
    return port.eval(), ref.eval()


def test_reference_frontend_equals_the_ports_at_float32():
    port, ref = _frontends(torch.float32)
    x = _images((1, 64, 96, 3)) * 2 - 1
    with torch.no_grad():
        a, b = port(x), ref(x)
    for name in ("keypoints_px", "descriptors", "scores", "confidence", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_fp8_control_departs_from_the_reference():
    port, ctl = _frontends(FP8)
    x = _images((1, 64, 96, 3), seed=1) * 2 - 1
    with torch.no_grad():
        a, b = port(x), ctl(x)
    cos = torch.nn.functional.cosine_similarity(a.features.flatten(1), b.features.flatten(1))
    assert float(cos) < 0.9999


def test_reference_segmenter_equals_the_ports_at_float32():
    path = str(ROOT / CONFIG["segmenter"]["checkpoint"])
    port = port_segmenter.SemanticSegmenter(**CONFIG["segmenter"]["sizes"], dtype=torch.float32)
    port.load_state_dict(convert.segmenter_state_dict(path))
    ref = ref_segmenter.SemanticSegmenter(**CONFIG["segmenter"]["sizes"], dtype=torch.float32)
    ref.load_state_dict(ref_weights.segmenter_state_dict(path))
    x = _images((2, 64, 96, 3), seed=2)
    with torch.no_grad():
        assert torch.equal(port(x, full_res=False), ref(x, full_res=False))


@pytest.mark.parametrize("value", [0.0, 1e-3, 1.0, 300.0])
def test_fp8_cast_rounds_onto_the_e4m3_grid(value):
    x = torch.tensor([value, -value / 3, 448.0 * (value > 0)])
    y = cast(x, FP8)
    scale = max(float(x.abs().max()), 1e-12) / 448.0
    assert torch.equal(y, (x / scale).to(FP8).float() * scale)
    assert torch.equal(cast(x, torch.float32), x)
