"""The control on the card: each configuration's reference one precision
below the one it states (TF32 for the ORB path's float32, fp8 for the
learned path's bfloat16) takes the port's place at the cell's own size,
on three seeds, and has to come out as not correct under the
configuration's limits. Needs a CUDA card; run on the chip with

    python3 -m pytest port_bench/tests/test_port_bench_control_chip.py -m gpu
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

SEEDS = (2147483601, 2147483602, 2147483603)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the chip at the cell's size")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["vits16.slam", "vits16.frontend", "orb.live"])
def test_control_is_not_correct(workload, card):
    from harness.reference_run import Reference
    from reference.camera import PinholeCamera

    r = bench.Run(Manifest(ROOT), workload, SEEDS[0], card)
    ref = Reference(r.config, ROOT, card)
    ctl = Reference(r.config, ROOT, card, precision="control")
    cam = PinholeCamera(**r.config["camera"])
    for seed in SEEDS:
        world = world_mod.render(r.traffic, cam, seed, r.config["slam"]["num_hypotheses"])
        got = ctl.run(world, r.drive.WITH_SLAM)
        want = ref.run(world, r.drive.WITH_SLAM, follow=got["features"])
        out = {"weight_map": got["weight_map"], "features": got["features"],
               "poses": [got["poses"]] if got["poses"] is not None else [], "truth": world.poses_wc}
        ok, table = check.judge(r.config, check.numbers(r.config, out, want))
        assert not ok, (seed, table)
