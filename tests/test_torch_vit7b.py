"""DINOv3 ViT-7B/16 as the learned frontend's backbone: the port's
``models/backbone.py`` with RoPE, SwiGLU and LayerScale against the plain
reference ``port_bench/reference/frontend_vit7b.py``, on the CPU at a small
size (d 64, 3 blocks, 2 heads of 32, a 4 x 5 patch grid) in float32, both
models holding the same weights drawn by the benchmark's
``harness/weights.py`` with the configuration's LayerScale constant; RoPE's
properties; faults the comparison must catch; the ViT-S default left as it
was; the configuration, the full-size model and the FLOP count tied
together; and ``run-slam --frontend learned`` on a YAML that sets the new
fields, whose trace carries the new spans and counter."""

from __future__ import annotations

import json
import math
import sys
from functools import partial
from pathlib import Path

import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import counters, weights  # noqa: E402
from harness.manifest import check_config  # noqa: E402
from reference import frontend as frozen_frontend  # noqa: E402
from reference import frontend_vit7b as ref_vit7b  # noqa: E402

from semantic_slam_master_tpu_torch import convert  # noqa: E402
from semantic_slam_master_tpu_torch.cli import run_slam_cli  # noqa: E402
from semantic_slam_master_tpu_torch.models import backbone as tbackbone  # noqa: E402
from semantic_slam_master_tpu_torch.models import frontend as tfrontend  # noqa: E402
from semantic_slam_master_tpu_torch.models import layers as tlayers  # noqa: E402
from semantic_slam_master_tpu_torch.train import config as tconfig  # noqa: E402
from semantic_slam_master_tpu_torch.utils import profiling  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "vit7b16_sem.json").read_text())
VITS = json.loads((BENCH / "configs" / "vits16_sem.json").read_text())
(GAMMA_RULE,) = CONFIG["model"]["weights"]["overrides"]
GAMMA = GAMMA_RULE[2]  # the configuration's LayerScale constant
CPU = torch.device("cpu")
# The configuration's architecture at a small size: 2 heads of 32, a SwiGLU
# of hidden 2.0 x 64, 4 registers; a 64 x 80 image is a 4 x 5 patch grid.
SMALL = dict(CONFIG["model"]["sizes"], embed_dim=64, depth=3, num_heads=2, selector_hidden=32,
             refiner_hidden=64, refiner_layers=3, descriptor_dim=32, estimator_hidden=32, num_keypoints=12,
             nms_radius=1)
IMAGE = (2, 64, 80, 3)
# Tolerances of the float32 comparison. Port and reference compute the same
# float32 arithmetic in other orders (a conv against a matmul patch
# embedding, complex against real rotations, einsum against matmul), so
# they read a few ulps apart: features 4.4e-06 at most, descriptors 8.5e-07,
# keypoints 7.6e-06 px, confidence 1.8e-07 over LayerScale constants 1e-5 to
# 0.3. Each limit leaves 10-50x room over that, and lies 2-5 orders of
# magnitude under what a fault makes at the configuration's constant.
TOL = {"features": 1e-4, "descriptors": 1e-5, "keypoints_px": 1e-3, "confidence": 1e-5}


def spec(gamma=GAMMA, seed=5) -> dict:
    return {"weights": {"seed": seed, "overrides": [[GAMMA_RULE[0], "const", gamma]]}}


def port_model(gamma=GAMMA, **sizes):
    make = partial(tfrontend.LearnedFrontend, **dict(SMALL, **sizes), dtype=torch.float32)
    return weights.drawn(make, spec(gamma), CPU)


def ref_model(gamma=GAMMA):
    make = partial(ref_vit7b.LearnedFrontend, **SMALL, dtype=torch.float32)
    return weights.drawn(make, spec(gamma), CPU)


def images(shape=IMAGE, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def gaps(out, ref) -> dict:
    """Largest absolute gap per compared output; inf where the valid
    keypoint sets differ."""
    g = {k: float((getattr(out, k).float() - getattr(ref, k).float()).abs().max()) for k in TOL}
    if not torch.equal(out.valid, ref.valid):
        g["keypoints_px"] = math.inf
    return g


def within(g: dict) -> bool:
    return all(g[k] <= TOL[k] for k in TOL)


@pytest.fixture(scope="module")
def ref_out():
    with torch.no_grad():
        return ref_model()(images())


@pytest.fixture(scope="module")
def port_out():
    with torch.no_grad():
        return port_model()(images())


# --- the port against the reference ------------------------------------------

@pytest.mark.parametrize("name", sorted(TOL))
def test_port_agrees_with_the_reference(name, port_out, ref_out):
    assert int(port_out.valid.sum()) > 0 and torch.equal(port_out.valid, ref_out.valid)
    assert port_out.features.shape == (2, 4, 5, 64)
    assert gaps(port_out, ref_out)[name] <= TOL[name]


def _rope_off(monkeypatch, model):
    monkeypatch.setattr(tbackbone, "rope_apply", lambda x, cos, sin: x)


def _gelu_for_swiglu(monkeypatch, model):
    monkeypatch.setattr(tbackbone, "silu", tlayers.gelu)


def _gamma_one(monkeypatch, model):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(1.0)


FAULTS = {"rope_off": _rope_off, "gelu_for_swiglu": _gelu_for_swiglu, "gamma_one": _gamma_one}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_faulty_port_fails_the_comparison(fault, monkeypatch, ref_out):
    model = port_model()
    FAULTS[fault](monkeypatch, model)
    with torch.no_grad():
        g = gaps(model(images()), ref_out)
    assert not within(g), g
    assert g["features"] > 100 * TOL["features"], g


@pytest.mark.parametrize("fault", ["rope_off", "gelu_for_swiglu"])
def test_dinov3_initial_gamma_would_hide_the_faults(fault, monkeypatch):
    """Why the configuration draws its gammas as a constant well above
    DINOv3's initial 1e-5: there the blocks barely touch the residual
    stream, and a port without RoPE or with GELU still passes."""
    ref = ref_model(gamma=1e-5)
    model = port_model(gamma=1e-5)
    FAULTS[fault](monkeypatch, model)
    with torch.no_grad():
        assert within(gaps(model(images()), ref(images())))


# --- RoPE ------------------------------------------------------------------------

def test_rope_keeps_norms():
    cos, sin = tbackbone.rope_tables(4, 5, 32)
    x = torch.randn(2, 3, 20, 32, generator=torch.Generator().manual_seed(1))
    y = tbackbone.rope_apply(x, cos, sin)
    assert not torch.allclose(y, x)
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1), rtol=1e-6, atol=0)


def test_rotated_scores_depend_only_on_the_grid_offset():
    gh, gw, hd = 6, 7, 32
    cos, sin = tbackbone.rope_tables(gh, gw, hd)
    gen = torch.Generator().manual_seed(2)
    q, k = torch.randn(hd, generator=gen, dtype=torch.float64), torch.randn(hd, generator=gen, dtype=torch.float64)

    def score(qi, qj, ki, kj):
        a, b = qi * gw + qj, ki * gw + kj
        rq = tbackbone.rope_apply(q, cos[a].double(), sin[a].double())
        rk = tbackbone.rope_apply(k, cos[b].double(), sin[b].double())
        return float(rq @ rk)

    base = score(1, 2, 3, 1)
    for dy, dx in [(1, 0), (0, 3), (2, 4), (-1, -1)]:
        assert score(1 + dy, 2 + dx, 3 + dy, 1 + dx) == pytest.approx(base, abs=1e-5)
    assert abs(score(1, 2, 3, 2) - base) > 1e-3  # another offset, another score


def test_prefix_tokens_pass_unrotated(monkeypatch):
    """RoPE is applied to the patch tokens' q and k alone: the 20 patches
    of the 4 x 5 grid, never the CLS and 4 register tokens."""
    rotated = []
    plain = tbackbone.rope_apply

    def seen(x, cos, sin):
        rotated.append(x.shape[2])
        return plain(x, cos, sin)

    monkeypatch.setattr(tbackbone, "rope_apply", seen)
    model = port_model()
    with torch.no_grad():
        model.backbone(images())
    assert rotated == [20] * (2 * SMALL["depth"])


def test_rope_tables_are_not_module_state():
    model = port_model()
    assert not any("rope" in k or "pos_embed" in k for k in model.state_dict())
    assert model.backbone.pos_embed is None
    assert {k for k, _ in model.named_buffers()} == {"backbone.feature_norm.running_mean",
                                                     "backbone.feature_norm.running_var"}


# --- the ViT-S default ---------------------------------------------------------

VITS_SIZES = dict(VITS["model"]["sizes"], embed_dim=64, depth=2, num_heads=2, pos_grid=8, selector_hidden=32,
                  refiner_hidden=64, refiner_layers=3, descriptor_dim=32, estimator_hidden=32, num_keypoints=12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vits_default_is_the_frozen_reference_bit_for_bit(dtype):
    """The defaults build the ViT-S block as before this architecture was
    added: the benchmark's frozen copy of the earlier port computes the
    same bits."""
    seeded = {"weights": {"seed": 9}}
    port = weights.drawn(partial(tfrontend.LearnedFrontend, **VITS_SIZES, dtype=dtype), seeded, CPU)
    ref = weights.drawn(partial(frozen_frontend.LearnedFrontend, **VITS_SIZES, dtype=dtype), seeded, CPU)
    weights.same_shapes(weights.shapes(port), weights.shapes(ref), "ViT-S")
    x = images((1, 64, 96, 3), seed=3)
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert int(a.valid.sum()) > 0
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_vits_weights_still_load_strictly():
    model = tfrontend.LearnedFrontend(**VITS["model"]["sizes"], generator=torch.Generator().manual_seed(0))
    sd = convert.frontend_state_dict(str(REPO / VITS["model"]["checkpoint"]))
    model.load_state_dict(sd, strict=True)
    assert not any(".ls1." in k or ".w1." in k for k in sd) and "backbone.pos_embed" in sd


# --- the configuration, the full-size model and the FLOP count ------------------

def test_config_passes_the_manifest_check():
    check_config(CONFIG, "port_bench/configs/vit7b16_sem.json")
    m = CONFIG["model"]
    assert m["reference"] == "frontend_vit7b" and "weights" in m and "checkpoint" not in m
    # The FLOP count reads num_registers, mlp_ratio and ffn at the top
    # level: they are what the block that ``sizes`` builds holds.
    assert [m[k] for k in ("num_registers", "mlp_ratio", "ffn")] == counted(port_model().backbone)
    assert m["mlp_ratio"] == m["sizes"]["mlp_ratio"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert entry["reduced"] == [] and entry["file"] == "port_bench/configs/vit7b16_sem.json"


def counted(backbone) -> list:
    """(registers, mlp_ratio, feed-forward kind) of a built port backbone."""
    mlp = backbone.blocks[0].mlp
    ffn = "swiglu" if isinstance(mlp, tbackbone.SwiGLU) else "gelu_mlp"
    hidden = (mlp.w1 if ffn == "swiglu" else mlp.fc1).weight.shape[0]
    return [backbone.num_registers, hidden / backbone.embed_dim, ffn]


@pytest.fixture(scope="module")
def full_size():
    sizes = CONFIG["model"]["sizes"]
    with torch.device("meta"):
        return (tfrontend.LearnedFrontend(**sizes, dtype=torch.bfloat16),
                ref_vit7b.LearnedFrontend(**sizes, dtype=torch.float32))


def test_full_size_port_and_reference_hold_the_same_state_dict(full_size):
    port, ref = full_size
    shapes = weights.shapes(port)
    weights.same_shapes(shapes, weights.shapes(ref), "vit7b16_sem")
    b = port.backbone
    assert (b.embed_dim, len(b.blocks), b.num_heads, b.num_registers) == (4096, 40, 32, 4)
    assert b.blocks[0].mlp.w1.weight.shape == (8192, 4096) and b.blocks[0].attn.qkv.bias is None
    assert b.pos_embed is None and b.rope and b.blocks[0].ls1 is not None
    assert counted(b) == [CONFIG["model"][k] for k in ("num_registers", "mlp_ratio", "ffn")]
    n = sum(p.numel() for p in port.backbone.parameters())
    assert 6.6e9 < n < 6.8e9, n


def test_flop_count_is_the_backbone_that_runs():
    """``counters.vit_flops(..., ffn="swiglu")``, behind ``mfu.frontend``,
    equals PyTorch's FLOP count of the port's backbone at the small size."""
    model = port_model()
    H, W = IMAGE[1:3]
    got = profiling.stage_cost(model.backbone, (images((1, H, W, 3)),))["flops"]
    s, m = SMALL, CONFIG["model"]
    want = counters.vit_flops(H, W, s["embed_dim"], s["depth"], s["num_heads"], s["patch_size"],
                              m["num_registers"], m["mlp_ratio"], ffn=m["ffn"])
    assert got == want
    assert want != counters.vit_flops(H, W, s["embed_dim"], s["depth"], s["num_heads"], s["patch_size"],
                                      m["num_registers"], m["mlp_ratio"], ffn="gelu_mlp")


# --- the normal CLI path ---------------------------------------------------------

NEW_FIELDS = {"backbone_mlp_ratio": 2.0, "backbone_block": "dinov3"}


def test_train_config_builds_the_vit7b_family():
    cfg = tconfig.load_model_config(REPO / "configs" / "train_vit7b16_synthetic.yaml")
    assert (cfg.backbone_dim, cfg.backbone_depth, cfg.backbone_heads) == (4096, 40, 32)
    assert (cfg.backbone_block, cfg.backbone_mlp_ratio) == ("dinov3", 2.0)
    sizes = CONFIG["model"]["sizes"]
    with torch.device("meta"):
        built = tconfig.build_model(cfg)
        direct = tfrontend.LearnedFrontend(**sizes)
    assert weights.shapes(built) == weights.shapes(direct)


def test_run_slam_learned_on_the_new_backbone(tmp_path, capsys):
    raw = yaml.safe_load((REPO / "configs" / "train_tiny_synthetic.yaml").read_text())
    raw["model"].update(NEW_FIELDS, backbone_dim=64, backbone_heads=2, backbone_depth=2, num_keypoints=64)
    path = tmp_path / "vit7b_tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    args = ["--synthetic", "--synthetic-frames", "6", "--synthetic-scale", "0.5", "--num-landmarks", "512",
            "--window-size", "3", "--ba-iters", "2", "--device", "cpu", "--output-dir", str(out),
            "--frontend", "learned", "--train-config", str(path)]
    assert run_slam_cli.main(args) == 0
    assert "'frontend': 'learned'" in capsys.readouterr().out
    run = json.loads(next(out.glob("*_run.json")).read_text())
    spans = run["trace"]["spans"]
    chunks = spans["frontend.backbone"]["count"]
    assert chunks >= 1
    for name in ("frontend.backbone.attn", "frontend.backbone.ffn"):
        assert spans[name]["count"] == 2 * chunks, name
        assert spans[name]["host_ms"] <= spans["frontend.backbone"]["host_ms"]
    # The CLI's backbone computes in bfloat16: every backbone Dense casts
    # its float32 weights once a chunk.
    model = tconfig.build_model(tconfig.load_model_config(path))
    per_chunk = sum(m.weight.nbytes + (m.bias.nbytes if m.bias is not None else 0)
                    for m in model.backbone.modules() if isinstance(m, tlayers.Dense))
    assert run["trace"]["counters"][tlayers.WEIGHT_CAST_BYTES] == per_chunk * chunks
