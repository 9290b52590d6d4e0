"""The control of ``vit7b.frontend`` on the card: the DINOv3 ViT-7B/16
reference with float8 e4m3 operands takes the port's place on three
seeds and has to come out as not correct under ``vit7b16_sem``'s limits.
Two float32 7B models (~27 GB each) and their work do not fit beside each
other, so the control runs first, is freed, and then the reference runs
over the same worlds. Needs a CUDA card; run on the chip with

    python3 -m pytest port_bench/tests/test_port_bench_vit7b_chip.py -m gpu
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import bench, check  # noqa: E402
from harness import world as world_mod  # noqa: E402
from harness.manifest import Manifest  # noqa: E402

SEEDS = (2147483611, 2147483612, 2147483613)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the 7B control is read on the chip at the cell's size")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_vit7b_control_is_not_correct(card):
    from harness.reference_run import Reference
    from reference.camera import PinholeCamera

    r = bench.Run(Manifest(ROOT), "vit7b.frontend", SEEDS[0], card)
    cam = PinholeCamera(**r.config["camera"])
    worlds = {s: world_mod.render(r.traffic, cam, s, r.config["slam"]["num_hypotheses"]) for s in SEEDS}
    ctl = Reference(r.config, ROOT, card, precision="control")
    got = {s: ctl.run(w, r.drive.WITH_SLAM) for s, w in worlds.items()}
    shapes = ctl.weight_shapes
    del ctl
    bench.free(card)
    ref = Reference(r.config, ROOT, card)
    bench.same_weights(shapes, ref)
    for seed, world in worlds.items():
        want = ref.run(world, r.drive.WITH_SLAM)
        out = {"weight_map": got[seed]["weight_map"], "features": got[seed]["features"], "poses": [],
               "truth": world.poses_wc}
        ok, table = check.judge(r.config, check.numbers(r.config, out, want))
        assert not ok, (seed, table)
