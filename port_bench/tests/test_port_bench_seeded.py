"""Seeded weights (``harness/weights.py``), the reference module named by a
configuration and the FLOPs of its declared feed-forward block, on the
CPU: a draw depends on the seed and the key alone, the port and the
reference built from one seed hold the same tensors and agree at float32
while the fp8 control does not, a configuration that names no weights,
both, or an unknown reference module is refused, and the FLOP counts
hold to the integer."""

from __future__ import annotations

import copy
import json
import math
import random
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import bench, counters, weights  # noqa: E402
from harness.manifest import Manifest, check_config  # noqa: E402
from harness.program import Program  # noqa: E402
from harness.reference_run import Reference, frontend_module  # noqa: E402
from reference.layers import FP8  # noqa: E402
from semantic_slam_master_tpu_torch.models import frontend as port_frontend  # noqa: E402

VITS = json.loads((BENCH / "configs" / "vits16_sem.json").read_text())
# The port's ``tiny_frontend`` sizes, with sub-patch refinement so that the
# offset head's keys are drawn too.
TINY = dict(embed_dim=64, depth=2, num_heads=2, patch_size=16, pos_grid=8, selector_hidden=32,
            refiner_hidden=64, refiner_layers=3, descriptor_dim=32, estimator_hidden=32, num_keypoints=24,
            nms_radius=2, subpatch_refine=True)
CPU = torch.device("cpu")


def seeded_config(seed: int = 7, overrides=()) -> dict:
    c = copy.deepcopy(VITS)
    m = c["model"]
    del m["checkpoint"]
    m.update(sizes=TINY, weights={"seed": seed, "overrides": [list(o) for o in overrides]})
    s = c["segmenter"]
    del s["checkpoint"]
    s["weights"] = {"seed": seed + 1}
    return c


def tiny_shapes() -> dict:
    with torch.device("meta"):
        return weights.shapes(port_frontend.LearnedFrontend(**TINY))


def _images(shape, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def test_draws_are_bit_equal_whatever_the_key_order():
    shapes = tiny_shapes()
    a = weights.draw(shapes, 11)
    b = weights.draw(shapes, 11)
    keys = list(shapes)
    random.Random(0).shuffle(keys)
    c = weights.draw({k: shapes[k] for k in keys}, 11)
    d = weights.draw(shapes, 12)
    assert list(a) == list(shapes)
    for k in shapes:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    assert not any(torch.equal(a[k], d[k]) for k in shapes if a[k].numel() > 1)


def test_default_rule():
    sd = weights.draw(tiny_shapes(), 3)
    w = sd["backbone.blocks.0.mlp.fc1.weight"]  # (256, 64): fan_in 64
    assert float(w.abs().max()) <= 2 / math.sqrt(64) and 0.9 < float(w.std() * 8) < 1.1
    conv = sd["backbone.patch_embed.weight"]  # (64, 3, 16, 16): fan_in 768
    assert float(conv.abs().max()) <= 2 / math.sqrt(768)
    # flax's (3, 3, in, out) layout: fan_in 3 x 3 x 64, not 3 x 64 x 32.
    kernel = sd["selector.conv1_kernel"]
    assert kernel.shape == (3, 3, 64, 32)
    assert float(kernel.abs().max()) <= 2 / math.sqrt(576) * (1 + 1e-6) and 0.9 < float(kernel.std() * 24) < 1.1
    scale = sd["backbone.blocks.0.norm1.weight"]
    assert float((scale - 1).abs().max()) < 0.1 and float(scale.std()) > 0
    for k in ("backbone.blocks.0.attn.qkv.bias", "backbone.cls_token", "backbone.register_tokens",
              "backbone.pos_embed", "backbone.feature_norm.running_mean", "selector.conv1_bias"):
        assert 0.01 < float(sd[k].std()) < 0.03 and float(sd[k].mean().abs()) < 0.01, k
    assert float(sd["backbone.feature_norm.running_var"].min()) >= 1.0
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_overrides_apply_and_must_match():
    overrides = [[r"norm1\.weight$", "const", 1e-5], [r"attn\.qkv\.weight$", "std", 0.5]]
    sd = weights.draw(tiny_shapes(), 5, overrides)
    plain = weights.draw(tiny_shapes(), 5)
    for b in range(TINY["depth"]):
        assert torch.equal(sd[f"backbone.blocks.{b}.norm1.weight"], torch.full((64,), 1e-5))
        qkv = sd[f"backbone.blocks.{b}.attn.qkv.weight"]
        assert float(qkv.abs().max()) <= 1.0 and 0.4 < float(qkv.std()) < 0.5
    assert torch.equal(sd["backbone.blocks.0.norm2.weight"], plain["backbone.blocks.0.norm2.weight"])
    with pytest.raises(ValueError, match="match no key"):
        weights.draw(tiny_shapes(), 5, [[r"ls1\.gamma$", "const", 1e-5]])


def test_seeded_port_and_reference_hold_identical_state_dicts():
    config = seeded_config()
    port = Program(config, ROOT, CPU)
    ref = Reference(config, ROOT, CPU)
    ctl = Reference(config, ROOT, CPU, precision="control")
    bench.same_weights(port.weight_shapes, ref)
    bench.same_weights(port.weight_shapes, ctl)
    for a, b, c in ((port.frontend, ref.frontend, ctl.frontend), (port.segmenter, ref.segmenter, ctl.segmenter)):
        sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
        assert list(sa) == list(sb) == list(sc)
        for k in sa:
            assert not sa[k].is_meta and torch.equal(sa[k], sb[k]) and torch.equal(sa[k], sc[k]), k


def _seeded_frontends(dtype):
    spec = seeded_config()["model"]
    port = weights.drawn(lambda: port_frontend.LearnedFrontend(**TINY, dtype=torch.float32), spec, CPU)
    ref_mod = frontend_module(seeded_config())
    ref = weights.drawn(lambda: ref_mod.LearnedFrontend(**TINY, dtype=dtype), spec, CPU)
    return port, ref


def test_seeded_reference_frontend_equals_the_ports_at_float32():
    port, ref = _seeded_frontends(torch.float32)
    x = _images((1, 64, 96, 3))
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert int(a.valid.sum()) > 0
    for name in ("keypoints_px", "descriptors", "scores", "confidence", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_seeded_fp8_control_departs_from_the_reference():
    port, ctl = _seeded_frontends(FP8)
    x = _images((1, 64, 96, 3), seed=1)
    with torch.no_grad():
        a, b = port(x), ctl(x)
    cos = torch.nn.functional.cosine_similarity(a.features.flatten(1), b.features.flatten(1))
    assert float(cos) < 0.9999


def _both(c):
    c["model"]["checkpoint"] = VITS["model"]["checkpoint"]


def _neither(c):
    del c["model"]["weights"]


def _segmenter_both(c):
    c["segmenter"]["checkpoint"] = VITS["segmenter"]["checkpoint"]


def _segmenter_neither(c):
    del c["segmenter"]["weights"]


def _bad_override(c):
    c["model"]["weights"]["overrides"] = [["norm", "scale", 1.0]]


def _unknown_reference(c):
    c["model"]["reference"] = "frontend_vit7b_missing"


def _path_reference(c):
    c["model"]["reference"] = "../harness/bench"


def _unknown_ffn(c):
    c["model"]["ffn"] = "geglu"


def _ffn_with_width(c):
    # The hidden width is mlp_ratio x d, stated once.
    c["model"]["ffn"] = {"kind": "swiglu", "hidden": 8192}


@pytest.mark.parametrize("breaks,says", [
    (_both, "model gives both"), (_neither, "model gives neither"),
    (_segmenter_both, "segmenter gives both"), (_segmenter_neither, "segmenter gives neither"),
    (_bad_override, "overrides"), (_unknown_reference, "names no module"),
    (_path_reference, "names no module"), (_unknown_ffn, "model.ffn"), (_ffn_with_width, "model.ffn"),
])
def test_config_is_refused_before_a_run(breaks, says, tmp_path):
    config = seeded_config()
    check_config(config, "configs/x.json")
    breaks(config)
    with pytest.raises(ValueError, match=says) as e:
        check_config(config, "configs/x.json")
    assert "configs/x.json" in str(e.value)
    # Through the manifest, as a run meets it: refused before set-up.
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "x.json").write_text(json.dumps(config))
    manifest = {"configs": [{"name": "x", "file": "configs/x.json"}],
                "workloads": [{"name": "x.frontend", "config": "x", "traffic": "orbit60.frontend", "chips": 1}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match=says):
        bench.Run(Manifest(tmp_path), "x.frontend", 1, CPU)


def test_existing_configurations_keep_their_checkpoints():
    m = Manifest(ROOT)
    for cell in m.data["workloads"]:
        config = m.config(cell)
        for part in ("model", "segmenter"):
            if part in config:
                assert "checkpoint" in config[part] and "weights" not in config[part]


def test_flops_follow_the_declared_block():
    # vits16_sem: ViT-S/16 at 1205 tokens, its heads and the segmenter.
    assert counters.model_flops_per_frame(VITS) == 91_419_130_240
    explicit = copy.deepcopy(VITS)
    explicit["model"]["ffn"] = "gelu_mlp"
    assert counters.model_flops_per_frame(explicit) == 91_419_130_240
    # DINOv3 ViT-7B/16's backbone at 640x480: d 4096, 40 blocks, 32 heads,
    # 4 registers, SwiGLU of hidden width 2.0 x 4096 = 8192; RoPE and
    # LayerScale count 0.
    vit7b = dict(height=480, width=640, embed_dim=4096, num_heads=32, patch_size=16, num_registers=4,
                 mlp_ratio=2.0, ffn="swiglu")
    assert counters.vit_flops(depth=40, **vit7b) == 17_132_385_075_200
    assert counters.vit_flops(depth=1, **vit7b) - counters.vit_flops(depth=0, **vit7b) == 428_120_883_200
    # A SwiGLU block counts a third d x hidden product more than a GELU MLP.
    t, d = 1205, 4096
    gelu = counters.vit_flops(depth=1, **dict(vit7b, ffn="gelu_mlp"))
    assert counters.vit_flops(depth=1, **vit7b) - gelu == 2 * t * d * 8192
