"""A run driven on the CPU past the harness's look for a chip, with the
timed path broken underneath: ``correct`` has to come out false for each
fault a cell can have, and true for the sound ORB path, which the
reference reproduces bit for bit. One chip, so no cell has an exchange
between chips to leave out; the live drive hands in one frame at a time,
so it has no batch to halve.

The world is cut to a few small frames so that a test run holds it; the
limits are the configurations' own. The cut world tracks worse than the
full one (the learned cells' ATE passes its limit there), so a fault has
to fail a number other than ``ate_m``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import bench  # noqa: E402
from harness.manifest import Manifest  # noqa: E402
from semantic_slam_master_tpu_torch.slam import system, tracking  # noqa: E402

SEED = 2**31 + 77


def small_run(workload: str) -> bench.Run:
    r = bench.Run(Manifest(ROOT), workload, SEED, torch.device("cpu"), render_workers=1)
    scale = 0.25 if r.config["frontend"] == "orb" else 0.4  # the ViT needs multiples of 16
    c = r.config["camera"]
    r.config["camera"] = dict(fx=c["fx"] * scale, fy=c["fy"] * scale, cx=c["cx"] * scale, cy=c["cy"] * scale,
                              width=int(c["width"] * scale), height=int(c["height"] * scale))
    r.traffic = dict(r.traffic, frames=6)
    if r.config["frontend"] == "orb":
        r.traffic["frames"] = 12  # at 6 frames, too coarse an orbit for the ATE limit
        r.config["orb"]["num_keypoints"] = 128
        r.config["chunk"] = 4
    else:
        r.config["model"]["sizes"]["num_keypoints"] = 96
        r.config["chunk"] = 4
    return r


def correct(r: bench.Run) -> bool:
    torch.manual_seed(0)
    r.setup()
    r.window(0.0, False)
    ok, _, table = r.check()
    return ok, table


def frozen_step(u, feats, cam, cfg, state, T_prev_wc, since):
    """A SLAM step that returns its state unchanged."""
    zero = torch.zeros((), dtype=torch.int64)
    return state, T_prev_wc, since + 1, zero, zero, False


def half_batch(fn):
    """The frontend on the first half of each chunk, its output repeated
    for the rest."""

    frames_arg = 1 if fn is tracking.extract_learned_features else 0

    def wrapped(*args, **kwargs):
        n = args[frames_arg].shape[0]
        if n < 2:
            return fn(*args, **kwargs)
        h = (n + 1) // 2
        cut = [a[:h] if isinstance(a, torch.Tensor) and a.shape[:1] == (n,) else a for a in args]
        kw = {k: (v[:h] if isinstance(v, torch.Tensor) and v.shape[:1] == (n,) else v) for k, v in kwargs.items()}
        out = fn(*cut, **kw)
        return type(out)(*[torch.cat([o, o[: n - h]]) for o in out])

    return wrapped


def altered_pose(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        poses = out.poses_wc.clone()
        poses[-1, 0, 3] += 0.05
        return out._replace(poses_wc=poses)

    return wrapped


def altered_live_pose(fn):
    def wrapped(*args, **kwargs):
        (state, T, since), out = fn(*args, **kwargs)
        T = T.clone()
        T[0, 3] += 0.05
        return (state, T, since), out

    return wrapped


def altered_features(fn):
    """The first frame's descriptors negated (learned) or bit-flipped (ORB)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        desc = out.desc.clone()
        desc[0] = -desc[0] if torch.is_floating_point(desc) else ~desc[0]
        return out._replace(desc=desc)

    return wrapped


@pytest.mark.parametrize("workload", ["orb.live"])
def test_sound_orb_run_is_correct(workload):
    ok, table = correct(small_run(workload))
    assert ok, table


FAULTS = [
    ("orb.live", "frozen_step"), ("orb.live", "altered"),
    ("vits16.slam", "frozen_step"), ("vits16.slam", "half_batch"), ("vits16.slam", "altered"),
    ("vits16.frontend", "half_batch"), ("vits16.frontend", "altered"),
]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    r = small_run(workload)
    learned = r.config["frontend"] == "learned"
    extract = "extract_learned_features" if learned else "extract_features"
    if fault == "frozen_step":
        monkeypatch.setattr(system, "slam_step", frozen_step)
    elif fault == "half_batch":
        monkeypatch.setattr(tracking, extract, half_batch(getattr(tracking, extract)))
    elif r.traffic["drive"] == "slam":
        monkeypatch.setattr(system, "run_slam", altered_pose(system.run_slam))
    elif r.traffic["drive"] == "live":
        monkeypatch.setattr(system, "run_slam_steps", altered_live_pose(system.run_slam_steps))
    else:
        monkeypatch.setattr(tracking, extract, altered_features(getattr(tracking, extract)))
    ok, table = correct(r)
    assert not ok, table
    assert any(v > lim for k, (v, lim) in table.items() if k != "ate_m"), table
