"""The port's four new commands (``visualize``, ``bench``, ``check-setup``,
``download-tum``), ``evaluate --plots`` and the ``run-tests`` dashboard,
against the JAX CLI on the CPU: the dispatcher's ten commands, exit codes,
JSON keys, the files written, and the device half of each ``visualize``
mode.

Tolerances, and why: the ORB path (FAST, describe, Hamming matching) is
bit-exact between the packages on the CPU, so keypoints, matches and
their counts are held exactly; the pooled FAST saliency is a mean of 256
floats in each library's own order (within 1e-6); the learned saliency
runs a tiny f32 frontend from the same flax weights, within 1e-5 as in
tests/test_torch_learned_slam.py. ``bench`` is held by its keys, not its
times (a CPU time says nothing of the card): the JAX CLI's stage timer
is stubbed to keep its run short. No test fetches a URL: the downloader
meets a patched ``urlretrieve``.
"""

import functools
import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu import __main__ as jdispatcher
from semantic_slam_master_tpu.cli import bench_cli as jbench_cli
from semantic_slam_master_tpu.cli import check_setup_cli as jcheck_setup_cli
from semantic_slam_master_tpu.cli import download_tum_cli as jdownload_cli
from semantic_slam_master_tpu.cli import evaluate_cli as jevaluate_cli
from semantic_slam_master_tpu.cli import visualize_cli as jvisualize_cli
from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.models import frontend as jfrontend
from semantic_slam_master_tpu.ops import fast as jfast
from semantic_slam_master_tpu.ops import image as jimage
from semantic_slam_master_tpu_torch import __main__ as dispatcher
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import bench_cli, check_setup_cli, download_tum_cli, evaluate_cli
from semantic_slam_master_tpu_torch.cli import run_tests_cli, visualize_cli
from semantic_slam_master_tpu_torch.data import trajectory_io
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.train import config as tconfig

CPU = torch.device("cpu")
TINY = dict(embed_dim=64, depth=2, num_heads=2, selector_hidden=32, refiner_hidden=64, refiner_layers=3,
            descriptor_dim=32, estimator_hidden=32, num_keypoints=64, pos_grid=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (six test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def plt_available():
    pytest.importorskip("matplotlib")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_dispatcher_lists_the_jax_commands(capsys):
    assert dispatcher.main([]) == 0
    listed = {line.split()[0] for line in capsys.readouterr().out.splitlines()[2:] if line.strip()}
    assert listed == set(jdispatcher.COMMANDS) and len(listed) == 10
    assert dispatcher.main(["no-such-command"]) == jdispatcher.main(["no-such-command"]) == 2


@pytest.mark.parametrize("mode", ["matches", "sequence", "saliency"])
def test_visualize_writes_its_png(mode, tmp_path, capsys, plt_available):
    """tests/test_cli.py's case (``matches --synthetic --frames 4 --scale
    0.25``) and the other two modes; the match count printed equals the
    JAX CLI's."""
    argv = [mode, "--synthetic", "--frames", "4", "--scale", "0.25", "--spacings", "1", "2"]
    assert dispatcher.main(["visualize", *argv, "--output", str(tmp_path / "p"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    png = {"matches": "matches.png", "sequence": "matches_sequence.png", "saliency": "saliency_analysis.png"}[mode]
    assert (tmp_path / "p" / png).stat().st_size > 0
    if mode == "matches":
        assert jvisualize_cli.main([*argv, "--output", str(tmp_path / "j")]) == 0
        assert out.splitlines()[-1].split(";")[0] == capsys.readouterr().out.splitlines()[-1].split(";")[0]


def test_saliency_map_orb_mode_matches_jax():
    """The device half of ``visualize saliency``: the FAST response pooled
    to 16-pixel cells and the valid FAST keypoints, as the JAX CLI
    computes them."""
    rgb = synthetic.make_sequence(num_frames=1, scale=0.5).frame(0)["rgb"].astype(np.float32)
    sal, kpts = visualize_cli.saliency_map(rgb, CPU)
    gray = jimage.rgb_to_gray(jnp.asarray(rgb)[None])
    score = jfast.fast_score(gray, 0.05)
    h, w = score.shape[1] // 16, score.shape[2] // 16
    ref = np.asarray(jimage.avg_pool_to(score[:, : h * 16, : w * 16], h, w))[0]
    ref = ref / (ref.max() + 1e-8)
    kp = jfast.detect(gray, 400, 0.05)
    np.testing.assert_allclose(sal, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(kpts, np.asarray(kp.xy)[0][np.asarray(kp.valid)[0]])
    assert sal.shape == (15, 20) and len(kpts) > 50


def test_saliency_map_checkpoint_mode_matches_jax(tmp_path, monkeypatch):
    """The device half of ``visualize saliency --checkpoint``: the default
    ModelConfig's frontend with the checkpoint's weights, on the raw frame,
    as the JAX CLI applies it; here the config is cut to tiny_frontend
    widths and f32 on both sides."""
    rgb = synthetic.make_sequence(num_frames=1, scale=0.5).frame(0)["rgb"].astype(np.float32)
    jm = jfrontend.tiny_frontend(dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 240, 320, 3))))
    ref = jax.device_get(jax.jit(jm.apply)(variables, jnp.asarray(rgb)[None]))
    ckpt = tmp_path / "tiny.npz"
    convert.save_npz(ckpt, variables)
    cfg = tconfig.ModelConfig(backbone_dim=64, backbone_depth=2, backbone_heads=2, selector_hidden=32,
                              refiner_hidden=64, refiner_layers=3, descriptor_dim=32, estimator_hidden=32,
                              num_keypoints=64, backbone_pos_grid=8)
    monkeypatch.setattr(tconfig, "ModelConfig", lambda: cfg)
    monkeypatch.setattr(tconfig, "build_model", functools.partial(tconfig.build_model, dtype=torch.float32))
    sal, kpts = visualize_cli.saliency_map(rgb, CPU, str(ckpt))
    np.testing.assert_allclose(sal, np.asarray(ref.saliency)[0, ..., 0], rtol=0, atol=1e-5)
    assert np.abs(kpts - np.asarray(ref.keypoints_px)[0]).max() <= 1e-3
    assert sal.shape == (15, 20) and kpts.shape == (64, 2)


def _fake_marginal_time_ms(fn, args, iters=32, base_iters=4):
    return {"mean_ms": 1.0, "overhead_ms": 0.0, "iters": iters}


def _tiny(cls):
    return lambda generator=None, **kw: cls(**TINY, **({"generator": generator} if generator else {}))


@pytest.mark.parametrize("frontend", ["orb", "learned"])
def test_bench_json_has_jax_keys(frontend, tmp_path, monkeypatch):
    """``bench``'s JSON against the JAX CLI's on the same small flags: the
    same keys, plus the card line (null off the card), and the same stage
    names (the learned ones from the JAX learned adapter). The JAX CLI's
    ``--frontend learned`` raises RecursionError (its ``Resized.__len__``
    calls ``len`` of the name it rebinds), so the learned JSON is held to
    the ORB run's keys. ``--frontend learned`` runs at tiny widths here
    (the card runs it at ViT-S/16)."""
    from semantic_slam_master_tpu.eval import frontend_tests as jfrontend_tests
    from semantic_slam_master_tpu.utils import profiling as jprofiling

    monkeypatch.setattr(jprofiling, "marginal_time_ms", _fake_marginal_time_ms)
    argv = ["--width", "160", "--height", "128", "--batch", "2", "--num-keypoints", "100"]
    assert jbench_cli.main(["--frontend", "orb", *argv, "--output", str(tmp_path / "j.json")]) == 0
    ref = json.loads((tmp_path / "j.json").read_text())
    if frontend == "learned":
        monkeypatch.setattr(tfrontend, "LearnedFrontend", _tiny(tfrontend.LearnedFrontend))
        jm = jfrontend.tiny_frontend()
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        ref_stages = set(jfrontend_tests.learned_adapter(jm, variables).stages(np.zeros((1, 64, 64, 3), np.float32)))
    else:
        ref_stages = set(ref["stages"]) - {"total"}
    assert bench_cli.main(["--frontend", frontend, *argv, "--output", str(tmp_path / "t.json"),
                           "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(got) == set(ref) | {"card"} and got["card"] is None and got["device"] == "cpu"
    assert got["batch"] == ref["batch"] == 2 and got["test"] == ref["test"] == "performance"
    if frontend == "orb":
        assert set(got["stages"]) == set(ref["stages"]) == {"fast_detect", "orb_describe", "hamming_match", "total"}
    else:
        assert set(got["stages"]) == ref_stages | {"total"} and "backbone" in ref_stages
    assert all("mean_ms" in v for v in got["stages"].values())
    assert got["fps"] > 0 and isinstance(got["passed"], bool)


def test_new_entry_points_default_to_cuda_and_raise_without_it(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        bench_cli.main(["--batch", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        visualize_cli.main(["matches", "--synthetic", "--frames", "2", "--scale", "0.25",
                            "--output", str(tmp_path)])


def test_check_setup_fails_without_a_card(tmp_path, capsys, no_card):
    """The port's check needs a CUDA card: here it reports FAIL and exits 1
    (the JAX CLI, on its CPU backend, passes)."""
    assert check_setup_cli.main(["--data-root", str(tmp_path / "none")]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] cuda devices" in out and out.strip().endswith("FAIL")
    assert "[ok] torch" in out and "[ok] semantic_slam_master_tpu_torch imports" in out


def _sequence_dir(root, name, parts=("rgb", "depth", "groundtruth")):
    d = root / name
    d.mkdir(parents=True)
    for p in ("rgb", "depth"):
        if p in parts:
            (d / p).mkdir()
            (d / p / "1.png").write_bytes(b"")
    if "groundtruth" in parts:
        (d / "groundtruth.txt").write_text("# gt\n")
    return d


def test_check_sequence_dir_matches_jax(tmp_path):
    dirs = [_sequence_dir(tmp_path, "full"), _sequence_dir(tmp_path, "part", ("rgb",)), tmp_path / "absent"]
    for d in dirs:
        assert check_setup_cli.check_sequence_dir(d) == jcheck_setup_cli.check_sequence_dir(d)
    assert check_setup_cli.REFERENCE_SEQUENCES == jcheck_setup_cli.REFERENCE_SEQUENCES
    assert download_tum_cli.SEQUENCES == jdownload_cli.SEQUENCES and download_tum_cli.BASE_URL == jdownload_cli.BASE_URL


def _tgz_of_sequence(name):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for member in (f"{name}/rgb/1.png", f"{name}/depth/1.png", f"{name}/groundtruth.txt"):
            info = tarfile.TarInfo(member)
            info.size = 2
            tar.addfile(info, io.BytesIO(b"ok"))
    return buf.getvalue()


@pytest.mark.parametrize("case", ["verify_only", "extracted", "incomplete", "unknown", "fetch_fails", "fetch_ok"])
def test_download_tum_matches_jax(case, tmp_path, monkeypatch, capsys):
    """Exit codes and printed statuses equal the JAX CLI's; fetches go to a
    patched ``urlretrieve`` (raising, or writing an archive)."""
    import urllib.request

    name = "rgbd_dataset_freiburg1_desk"
    fetched = []

    def urlretrieve(url, dest):
        fetched.append(url)
        if case == "fetch_fails":
            raise OSError("no network in this test")
        dest.write_bytes(_tgz_of_sequence(name))

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    results = []
    for pkg, main in (("jax", jdownload_cli.main), ("port", download_tum_cli.main)):
        root = tmp_path / pkg
        root.mkdir()
        if case == "extracted":
            _sequence_dir(root, name)
        elif case == "incomplete":
            _sequence_dir(root, name, ("rgb", "groundtruth"))
        argv = ["--data-root", str(root), "--sequences", "no_such_sequence" if case == "unknown" else name]
        rc = main(argv + (["--verify-only"] if case == "verify_only" else []))
        cap = capsys.readouterr()
        results.append((rc, [line.replace(str(root), "ROOT") for line in cap.out.splitlines() if line.startswith("[")],
                        "[FAIL]" in cap.err, "[unknown]" in cap.err))
    assert results[0] == results[1]
    rc = results[1][0]
    assert rc == {"verify_only": 0, "extracted": 0, "incomplete": 1, "unknown": 1, "fetch_fails": 1,
                  "fetch_ok": 0}[case]
    assert len(fetched) == (2 if case in ("fetch_fails", "fetch_ok") else 0)
    if case == "fetch_ok":
        assert (tmp_path / "port" / name / "groundtruth.txt").exists()
        assert not (tmp_path / "port" / f"{name}.tgz").exists()


def test_evaluate_writes_trajectory_plots(tmp_path, capsys, plt_available):
    """tests/test_cli.py's expectation: ``plots/<seq>_trajectory.png`` beside
    results.json, the scores equal to the JAX CLI's."""
    seq = synthetic.make_sequence(num_frames=12, scale=0.25)
    est = seq.poses_wc.copy()
    est[:, :3, 3] += np.random.default_rng(0).normal(0, 0.01, (12, 3))
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        trajectory_io.write_tum_trajectory(d / "room_trajectory.txt", seq.timestamps, est)
        trajectory_io.write_tum_trajectory(d / "room_groundtruth.txt", seq.timestamps, seq.poses_wc)
    assert jevaluate_cli.main(["--trajectories", str(tmp_path / "jax"), "--rpe-delta", "2"]) == 0
    assert evaluate_cli.main(["--trajectories", str(tmp_path / "port"), "--rpe-delta", "2"]) == 0
    ref = json.loads((tmp_path / "jax" / "results.json").read_text())["room"]
    got = json.loads((tmp_path / "port" / "results.json").read_text())["room"]
    assert got["status"] == "success"
    assert abs(got["ate"]["rmse"] - ref["ate"]["rmse"]) <= 1e-9
    assert (tmp_path / "port" / "plots" / "room_trajectory.png").stat().st_size > 0
    assert evaluate_cli.main(["--trajectories", str(tmp_path / "port"), "--plots", str(tmp_path / "elsewhere")]) == 0
    assert (tmp_path / "elsewhere" / "room_trajectory.png").exists()


@pytest.mark.parametrize("plots", [True, False])
def test_run_tests_dashboard(plots, tmp_path, plt_available):
    out = tmp_path / "t.json"
    argv = ["--synthetic", "--synthetic-frames", "4", "--frontend", "orb", "--difficulty", "easy",
            "--no-performance", "--device", "cpu", "--output", str(out)] + ([] if plots else ["--no-plots"])
    run_tests_cli.main(argv)
    assert out.exists()
    assert (tmp_path / "t_synthetic_room.png").exists() == plots
