"""The port end to end on the CPU: its own frontend into its own SLAM
loop on the synthetic world, scored by ATE (the bound of
tests/test_slam_system.py), and the ``run-slam`` / ``evaluate`` CLI."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.data import synthetic
from semantic_slam_master_tpu_torch.eval import ate_rpe
from semantic_slam_master_tpu_torch.slam import system

REPO = Path(__file__).resolve().parents[1]


def test_port_slam_recovers_trajectory():
    seq = synthetic.make_sequence(num_frames=12, scale=0.5)
    gray, depth = run_slam_cli.render(seq)
    feats = run_slam_cli.features_for_frames(gray, depth, 400, torch.device("cpu"), chunk=8)
    cfg = system.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
    out = system.run_slam(torch.Generator().manual_seed(0), feats, seq.cam, cfg)
    assert out.poses_wc.shape == (12, 4, 4)
    assert torch.isfinite(out.poses_wc).all()
    assert out.num_inliers[1:].min() > 15
    assert out.is_keyframe.sum() >= 2
    ate = ate_rpe.compute_ate(seq.poses_wc, out.poses_wc.numpy().astype(np.float64))
    assert ate["rmse"] < 0.03, ate


def test_cli_run_slam_then_evaluate(tmp_path):
    env_cmd = [sys.executable, "-m", "semantic_slam_master_tpu_torch"]
    run = subprocess.run(
        env_cmd + ["run-slam", "--synthetic", "--synthetic-frames", "6", "--synthetic-scale", "0.25",
                   "--num-keypoints", "200", "--num-landmarks", "512", "--window-size", "3",
                   "--ba-iters", "2", "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert run.returncode == 0, run.stderr
    traj = tmp_path / "synthetic_room_trajectory.txt"
    lines = [ln for ln in traj.read_text().splitlines() if not ln.startswith("#")]
    assert len(lines) == 6 and all(len(ln.split()) == 8 for ln in lines)
    ev = subprocess.run(
        env_cmd + ["evaluate", "--trajectories", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert ev.returncode == 0, ev.stderr
    res = json.loads((tmp_path / "results.json").read_text())["synthetic_room"]
    assert res["status"] == "success"
    assert np.isfinite(res["ate"]["rmse"]) and res["num_poses"] == 6


def test_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_slam_cli.main(["--synthetic", "--synthetic-frames", "2", "--device", "cuda"])


def test_trajectory_io_round_trip(tmp_path):
    from semantic_slam_master_tpu.data import trajectory_io as jio
    from semantic_slam_master_tpu_torch.data import trajectory_io as tio

    seq = synthetic.make_sequence(num_frames=10, scale=0.25)
    tio.write_tum_trajectory(tmp_path / "t.txt", seq.timestamps, seq.poses_wc)
    jio.write_tum_trajectory(tmp_path / "j.txt", seq.timestamps, seq.poses_wc)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    t_ts, t_poses = tio.read_tum_trajectory(tmp_path / "t.txt")
    j_ts, j_poses = jio.read_tum_trajectory(tmp_path / "t.txt")
    np.testing.assert_array_equal(t_ts, j_ts)
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-6)


def test_synthetic_and_eval_copies_match():
    from semantic_slam_master_tpu.data import synthetic as jsyn
    from semantic_slam_master_tpu.eval import ate_rpe as jate

    a = synthetic.make_sequence(num_frames=3, scale=0.25).frame(2)
    b = jsyn.make_sequence(num_frames=3, scale=0.25).frame(2)
    for k in ("rgb", "depth", "labels", "pose_wc"):
        np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(0)
    seq = synthetic.make_sequence(num_frames=30, scale=0.25)
    est = seq.poses_wc.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (30, 3))
    assert ate_rpe.evaluate_trajectory(seq.timestamps, seq.poses_wc, seq.timestamps, est) == \
        jate.evaluate_trajectory(seq.timestamps, seq.poses_wc, seq.timestamps, est)
