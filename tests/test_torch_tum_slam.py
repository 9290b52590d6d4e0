"""``run-slam --data-root`` of the port against the JAX CLI on the CPU, on
one TUM directory written from the synthetic world
(``make_sequence(scale=0.5)``, 12 frames, ``write_tum_sequence``) with the
same seed. The directory's name gives the fr2 camera; its entry in
``CAMERAS`` is set to fr2 at half scale in both packages for the test, so
the 320x240 frames decode and project with their own intrinsics.

Tolerances: timestamps and keyframes exact; translations within 1e-3 m
and rotation entries within 1e-3 (tests/test_torch_slam.py's bound for the
port's SLAM loop against JAX's), and the two ATEs within 1e-4 m. Also:
the batch decode and the per-frame decode give the JAX CLI's inputs bit
for bit, a missing sequence is recorded as ``missing_data`` and the run
goes on, ``--max-frames`` is honoured, the run's JSON names the
decoder, and without ``--device cpu`` the run asks for the card and raises
without one."""

import ast
import contextlib
import io
import json

import numpy as np
import pytest

from semantic_slam_master_tpu.cli import evaluate_cli as jevaluate_cli
from semantic_slam_master_tpu.cli import run_slam_cli as jrun_slam_cli
from semantic_slam_master_tpu.core import camera as jcamera
from semantic_slam_master_tpu.data import tum as jtum
from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli
from semantic_slam_master_tpu_torch.core import camera as pcamera
from semantic_slam_master_tpu_torch.data import synthetic, trajectory_io, tum

NAME = "rgbd_dataset_freiburg2_synthetic"
SMALL = ["--num-keypoints", "400", "--num-landmarks", "1024", "--window-size", "4", "--ba-iters", "3",
         "--seed", "3"]


@pytest.fixture(scope="module")
def half_scale_fr2():
    mp = pytest.MonkeyPatch()
    mp.setitem(jcamera.CAMERAS, "freiburg2", jcamera.TUM_FR2.scaled(0.5, 0.5))
    mp.setitem(pcamera.CAMERAS, "freiburg2", pcamera.TUM_FR2.scaled(0.5, 0.5))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory, half_scale_fr2):
    root = tmp_path_factory.mktemp("tum_root")
    tum.write_tum_sequence(synthetic.make_sequence(num_frames=12, scale=0.5), root, NAME)
    return root


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    out = {}
    for pkg, cli, extra in (("jax", jrun_slam_cli, []), ("port", run_slam_cli, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"out_{pkg}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["--data-root", str(data_root), "--sequences", NAME, "--output-dir", str(d)]
                            + SMALL + extra) == 0
            (jevaluate_cli if pkg == "jax" else evaluate_cli).main(
                ["--trajectories", str(d), "--data-root", str(data_root)])
        line = next(ln for ln in printed.getvalue().splitlines() if ln.startswith(f"{NAME}: "))
        out[pkg] = (d, ast.literal_eval(line[len(NAME) + 2:]))
    return out


def _trajectory(d):
    return np.loadtxt(d / f"{NAME}_trajectory.txt")


def test_trajectory_matches_jax_cli(runs):
    (jdir, _), (pdir, run) = runs["jax"], runs["port"]
    j, p = _trajectory(jdir), _trajectory(pdir)
    assert p.shape == j.shape == (12, 8)
    np.testing.assert_array_equal(p[:, 0], j[:, 0])
    np.testing.assert_allclose(p[:, 1:4], j[:, 1:4], atol=1e-3)
    np.testing.assert_allclose(trajectory_io.quat_to_matrix_f32(p[:, 4:8]), trajectory_io.quat_to_matrix_f32(j[:, 4:8]), atol=1e-3)
    assert run == json.loads((pdir / f"{NAME}_run.json").read_text())
    assert run["frames"] == 12 and run["finite_poses"]
    assert run["decoder"]["name"] == "native" and "decode_s" in run
    jres = json.loads((jdir / "results.json").read_text())[NAME]
    pres = json.loads((pdir / "results.json").read_text())[NAME]
    assert jres["status"] == pres["status"] == "success" and pres["num_poses"] == 12
    np.testing.assert_allclose(pres["ate"]["rmse"], jres["ate"]["rmse"], atol=1e-4)
    assert pres["ate"]["rmse"] < 0.03


def test_keyframes_and_inliers_match_jax_cli(runs):
    (_, jrun), (_, prun) = runs["jax"], runs["port"]
    assert prun["frames"] == jrun["frames"] == 12
    assert prun["keyframes"] == jrun["keyframes"] >= 2
    np.testing.assert_allclose(prun["mean_inliers"], jrun["mean_inliers"], rtol=1e-3)
    trace = prun["trace"]
    assert trace["frames"] == 12
    assert {"frontend.features", "stage.pad", "slam.run", "slam.bootstrap", "slam.steps", "slam.match",
            "slam.ransac", "slam.refine", "slam.map", "slam.ba"} <= set(trace["spans"])
    assert set(trace["spans"]["slam.match"]) == {"count", "host_ms", "self_ms"}
    assert trace["spans"]["slam.match"]["count"] == 11
    assert trace["counters"]["keyframes"] == prun["keyframes"] - 1  # the bootstrap frame is not counted
    assert trace["counters"]["host_syncs"] > 0


def test_inputs_follow_the_jax_decode_rule(data_root):
    p = tum.TUMSequence(data_root, NAME)
    j = jtum.TUMSequence(data_root, NAME)
    rgb, gray, depth, labels, decoder = run_slam_cli.load_frames(p, want_rgb=False)
    assert rgb is None and labels is None and decoder["name"] == "native"
    jgray, jdepth = j.load_all_gray_depth()
    np.testing.assert_array_equal(gray.view(np.uint32), jgray.view(np.uint32))
    np.testing.assert_array_equal(depth.view(np.uint32), jdepth.view(np.uint32))
    rgb, gray, depth, labels, decoder = run_slam_cli.load_frames(p, want_rgb=True)
    assert labels is None and decoder == {"name": "plain", "per_frame": True}
    jframes = [j.frame(i) for i in range(j.num_frames())]
    np.testing.assert_array_equal(rgb.view(np.uint32), np.stack([f["rgb"] for f in jframes]).view(np.uint32))
    np.testing.assert_array_equal(depth.view(np.uint32), np.stack([f["depth"] for f in jframes]).view(np.uint32))


def test_missing_sequence_and_max_frames(data_root, tmp_path, capsys):
    argv = ["--data-root", str(data_root), "--sequences", "rgbd_dataset_freiburg1_absent", NAME,
            "--max-frames", "4", "--output-dir", str(tmp_path), "--device", "cpu"] + SMALL
    assert run_slam_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "rgbd_dataset_freiburg1_absent: {'status': 'missing_data'}" in out
    assert _trajectory(tmp_path).shape == (4, 8)
    assert json.loads((tmp_path / f"{NAME}_run.json").read_text())["frames"] == 4
    assert not (tmp_path / "rgbd_dataset_freiburg1_absent_run.json").exists()


def test_run_slam_data_root_defaults_to_cuda(data_root, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_slam_cli.main(["--data-root", str(data_root), "--sequences", NAME, "--output-dir", str(tmp_path)])
