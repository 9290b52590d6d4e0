"""The port's CLI against the JAX package's rules on the CPU:

- ``run-slam`` hands ``system.run_slam`` the RANSAC uniforms the JAX
  ``run_slam`` draws from ``PRNGKey(--seed)``, bit for bit;
- seeded weights follow the JAX CLI's seeds: the segmenter's is 0 whatever
  ``--seed`` is, the learned frontend's is the train config's
  ``training.seed``;
- ``evaluate`` records an unreadable trajectory as ``{"status":
  "error"}``, scores the others and exits as the JAX CLI does."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.cli import evaluate_cli as jevaluate_cli
from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli
from semantic_slam_master_tpu_torch.data import synthetic, trajectory_io
from semantic_slam_master_tpu_torch.slam import system
from semantic_slam_master_tpu_torch.train import config as config_mod

REPO = Path(__file__).resolve().parents[1]
TINY_CONFIG = REPO / "configs" / "train_tiny_synthetic.yaml"


@pytest.mark.parametrize("seed", [1, 7])
def test_run_slam_cli_hands_run_slam_jax_uniforms(tmp_path, monkeypatch, seed):
    seen = {}
    real = system.run_slam

    def spy(uniforms, features, cam, cfg):
        seen["u"], seen["H"] = uniforms, cfg.num_hypotheses
        return real(uniforms, features, cam, cfg)

    monkeypatch.setattr(run_slam_cli.system, "run_slam", spy)
    frames = 4
    assert run_slam_cli.main([
        "--synthetic", "--synthetic-frames", str(frames), "--synthetic-scale", "0.25",
        "--num-keypoints", "150", "--num-landmarks", "256", "--window-size", "3", "--ba-iters", "1",
        "--device", "cpu", "--seed", str(seed), "--output-dir", str(tmp_path)]) == 0
    keys = jax.random.split(jax.random.PRNGKey(seed), frames)
    want = np.stack([np.zeros((seen["H"], 3), np.float32)]
                    + [np.asarray(jax.random.uniform(k, (seen["H"], 3))) for k in keys[1:]])
    got = seen["u"]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_segmenter_seed_ignores_cli_seed():
    import argparse

    def weights(seed):
        args = argparse.Namespace(seed=seed, segmenter_checkpoint=None)
        return run_slam_cli.load_segmenter(args, torch.device("cpu")).state_dict()

    a, b = weights(0), weights(5)
    ref = run_slam_cli.seg_mod.SemanticSegmenter(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in ref:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], ref[k]), k


def test_learned_frontend_seed_is_training_seed(tmp_path):
    import argparse

    cfg_path = tmp_path / "tiny_seed9.yaml"
    cfg_path.write_text(TINY_CONFIG.read_text().replace("  seed: 0", "  seed: 9"))
    assert config_mod.load_training_seed(TINY_CONFIG) == 0
    assert config_mod.load_training_seed(cfg_path) == 9
    assert config_mod.load_training_seed(None) == 0

    def weights(path, seed):
        args = argparse.Namespace(seed=seed, train_config=str(path), checkpoint=None)
        return run_slam_cli.load_learned_frontend(args, torch.device("cpu")).state_dict()

    a, b = weights(cfg_path, 0), weights(cfg_path, 3)
    ref = config_mod.build_model(config_mod.load_model_config(cfg_path),
                                 generator=torch.Generator().manual_seed(9)).state_dict()
    other = weights(TINY_CONFIG, 9)
    assert any(not torch.equal(ref[k], other[k]) for k in ref)
    for k in ref:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], ref[k]), k


def test_evaluate_records_a_bad_sequence_and_scores_the_rest(tmp_path):
    seq = synthetic.make_sequence(num_frames=30, scale=0.25)
    rng = np.random.default_rng(0)
    est = seq.poses_wc.copy()
    est[:, :3, 3] += rng.normal(scale=0.01, size=est[:, :3, 3].shape)
    for name in ("good", "bad"):
        trajectory_io.write_tum_trajectory(tmp_path / f"{name}_groundtruth.txt", seq.timestamps, seq.poses_wc)
    trajectory_io.write_tum_trajectory(tmp_path / "good_trajectory.txt", seq.timestamps, est)
    (tmp_path / "bad_trajectory.txt").write_text("0.0 not a pose at all, but eight fields\n")
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    for p in tmp_path.glob("*.txt"):
        shutil.copy(p, jax_dir / p.name)

    rc = evaluate_cli.main(["--trajectories", str(tmp_path)])
    jrc = jevaluate_cli.main(["--trajectories", str(jax_dir)])
    assert rc == jrc == 0
    res = json.loads((tmp_path / "results.json").read_text())
    jres = json.loads((jax_dir / "results.json").read_text())
    assert res["bad"]["status"] == jres["bad"]["status"] == "error"
    assert "could not convert" in res["bad"]["error"]
    assert res["good"]["status"] == jres["good"]["status"] == "success"
    assert res["good"]["num_poses"] == jres["good"]["num_poses"] == 30
    np.testing.assert_allclose(res["good"]["ate"]["rmse"], jres["good"]["ate"]["rmse"], rtol=1e-6)
    assert 0.005 < res["good"]["ate"]["rmse"] < 0.03
