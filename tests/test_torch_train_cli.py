"""The port's ``train`` CLI and its data against the JAX package's: the
synthetic and TUM pair batches (bit-equal for the same config and epoch),
resuming from the trained tiny frontend's epoch-65 state (the committed
``weights/frontend_tiny_state.npz``, written by ``export_weights.py``
from ``artifacts/frontend_tiny/best_model``), a save then ``--resume``
against an uninterrupted run, and both CLIs end to end on the CPU at a
small size (64 px input, 12 keypoints, the trained model's widths).

Tolerances, and why:
- the converted state equals the JAX restore exactly (a layout change);
- one resumed step at f32 on the two packages: loss components within
  2e-5 relative, batch statistics within 1e-5, moments within 3e-5 / 1e-4
  of the moment's largest entry, parameters within 0.5 of the learning
  rate (1e-6 at this count, the end of the cosine), as in
  tests/test_torch_trainer.py and for its reasons;
- the resumed CLI runs at bf16 (the trainer's dtype): the two frameworks
  round to bf16 at other points, so each per-epoch figure x agrees within
  BF16_GAP * (|x| + 0.01). The gap measured here (printed) is the
  yardstick that chip_smoke.py's resumed run on the card is held to, as a
  multiple;
- save then resume equals the uninterrupted run bit for bit (the CPU is
  deterministic; the card's scatter-adds are not).
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semantic_slam_master_tpu.cli import train_cli as jcli
from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import trainer as jtrainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import train_cli as tcli
from semantic_slam_master_tpu_torch.train import config as tconfig
from semantic_slam_master_tpu_torch.train import trainer as ttrainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread. Six test workers, each with one
    OpenMP thread per core, otherwise spin against each other (a 0.8 s
    test here took 70 s in the full parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "train_tiny_synthetic.yaml"
STATE = REPO / "weights" / "frontend_tiny_state.npz"
ARTIFACT = REPO / "artifacts" / "frontend_tiny" / "best_model"
SMALL = {"model": {"input_size": 64, "num_keypoints": 12},
         "dataset": {"synthetic_frames": 5, "synthetic_worlds": 1}, "training": {"batch_size": 2}}
BF16_GAP = 0.1
MESH_CLI_GAP = 1e-4


def _write_config(path, overrides):
    path.write_text(yaml.safe_dump(tconfig.to_dict(tconfig.load_config(TINY, overrides))))
    return path


def test_config_round_trip_and_mesh_refusal(tmp_path):
    """``load_config`` keeps ``mesh_data`` / ``mesh_model`` as the JAX loader
    does, and ``fit`` refuses a mesh the process group cannot hold: more
    than one rank with no group, or a group of another size (here one
    gloo rank in this process). It never trains on one device instead."""
    import datetime

    import torch.distributed as dist

    cfg = _write_config(tmp_path / "c.yaml", SMALL)
    assert jconfig.to_dict(jconfig.load_config(cfg)) == tconfig.to_dict(tconfig.load_config(cfg))
    mesh = {"training": {"mesh_data": 2, "mesh_model": 2}}
    tcfg = tconfig.load_config(TINY, mesh)
    assert (tcfg.training.mesh_data, tcfg.training.mesh_model) == (2, 2)
    assert tconfig.to_dict(tcfg) == jconfig.to_dict(jconfig.load_config(TINY, mesh))
    with pytest.raises(ValueError, match="no process group"):
        ttrainer.fit(tcfg, lambda epoch: iter(()), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="mesh 2x2 != 1 ranks"):
            ttrainer.fit(tcfg, lambda epoch: iter(()), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("split_seed", [0, 1])
def test_synthetic_pair_batches_bit_equal(split_seed):
    jcfg, tcfg = jconfig.load_config(TINY, SMALL), tconfig.load_config(TINY, SMALL)
    jb, tb = jcli._synthetic_pair_batches(jcfg, split_seed), tcli._synthetic_pair_batches(tcfg, split_seed)
    for epoch in (1, 2):
        a, b = list(jb(epoch)), list(tb(epoch))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_tum_pair_batches_bit_equal(tmp_path):
    from semantic_slam_master_tpu_torch.data import synthetic, tum

    name = "rgbd_dataset_freiburg2_synthetic"
    tum.write_tum_sequence(synthetic.make_sequence(num_frames=6), tmp_path, name)
    over = {**SMALL, "dataset": {"root": str(tmp_path), "train_sequences": [name], "val_sequences": [name]}}
    jcfg, tcfg = jconfig.load_config(TINY, over), tconfig.load_config(TINY, over)
    for is_train in (True, False):
        a = list(jcli._tum_pair_batches(jcfg, [name], is_train)(3))
        b = list(tcli._tum_pair_batches(tcfg, [name], is_train)(3))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for k in x:
                assert np.array_equal(x[k], y[k]), k


@pytest.fixture(scope="module")
def resumed():
    """The JAX epoch-65 state restored from orbax, one f32 step on both sides."""
    jcfg, tcfg = jconfig.load_config(TINY, SMALL), tconfig.load_config(TINY, SMALL)
    model, state = jtrainer.create_train_state(jcfg, 16)
    state, meta = jtrainer.restore_checkpoint(str(ARTIFACT), state)
    state = jax.device_get(state)
    tm, ts = ttrainer.create_train_state(tcfg, 16, dtype=torch.float32)
    ts, tmeta = ttrainer.restore_checkpoint(STATE, tm, ts)
    before = (convert.train_state_tree(state), ttrainer.checkpoint_tree(tm, ts), meta, tmeta)
    batch = next(iter(jcli._synthetic_pair_batches(jcfg, 0)(66)))
    jstep = jtrainer.make_train_step(model.clone(dtype=jnp.float32), jcfg, jtrainer.build_optimizer(jcfg, 16))
    state, jo = jstep(jax.tree.map(jnp.asarray, state), {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = ttrainer.build_optimizer(tcfg, 16, ttrainer.flax_order(ts.trainable))
    ts, to = ttrainer.make_train_step(tm, tcfg, ttx)(ts, ttrainer.to_device(batch, "cpu"))
    return before, (jax.device_get(jo), {k: float(v) for k, v in to.items()}), (
        convert.train_state_tree(jax.device_get(state)), ttrainer.checkpoint_tree(tm, ts)), ttx, jax.device_get(state)


def test_committed_state_is_the_jax_checkpoint(resumed):
    (jf, tf, meta, tmeta), _, _, _, _ = resumed
    assert set(jf) == set(tf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    assert int(jf["opt_state/adam_count"]) == int(jf["opt_state/schedule_count"]) == int(jf["step"]) > 0
    assert tmeta["epoch"] == meta["epoch"] == 65 and tmeta["params_only"] is False


def test_resumed_step_equals_jax(resumed):
    _, (jo, to), (jf, tf), ttx, _ = resumed
    for k in jo:
        np.testing.assert_allclose(to[k], float(jo[k]), rtol=2e-5, atol=2e-7, err_msg=k)
    lr = float(ttx.schedule(int(jf["opt_state/schedule_count"]) - 1))
    for k in jf:
        if jf[k].dtype.kind != "f":
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k.startswith("opt_state/"):
            moment = k.split("/")[1]
            scale = max(np.abs(v).max() for q, v in jf.items() if q.startswith(f"opt_state/{moment}/"))
            np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=(3e-5 if moment == "mu" else 1e-4) * scale,
                                       err_msg=k)
        else:
            assert np.abs(tf[k].astype(np.float64) - jf[k]).max() <= 0.5 * lr, k


def test_port_state_back_into_jax(resumed):
    """The port's state after its resumed step, carried back into the JAX
    ``TrainState`` (``convert.jax_train_state_fields`` on JAX's as the
    template): the same tree structure, and every array unchanged."""
    import dataclasses

    _, _, (_, tf), _, template = resumed
    back = dataclasses.replace(template, **convert.jax_train_state_fields(tf, template))
    assert jax.tree.structure(back) == jax.tree.structure(template)
    again = convert.train_state_tree(back)
    assert set(again) == set(tf)
    for k in tf:
        np.testing.assert_array_equal(again[k], tf[k], err_msg=k)


def test_save_then_resume_is_bit_equal(tmp_path):
    over = {**SMALL, "model": {**SMALL["model"], "backbone_dim": 32, "backbone_depth": 1, "backbone_heads": 2},
            "training": {"batch_size": 2, "epochs": 2, "val_interval": 1, "save_dir": str(tmp_path / "a")}}
    cfg = tconfig.load_config(TINY, over)
    train, val = tcli._synthetic_pair_batches(cfg, 0), tcli._synthetic_pair_batches(cfg, 1)
    m1, full, _ = ttrainer.fit(cfg, train, lambda: val(0), steps_per_epoch=4, device="cpu", dtype=torch.float32)
    m_full = ttrainer.checkpoint_tree(m1, full)
    cfg.training.save_dir = str(tmp_path / "b")

    def interrupted(epoch):  # the run dies after epoch 1's checkpoint
        if epoch == 2:
            raise KeyboardInterrupt
        return train(epoch)

    with pytest.raises(KeyboardInterrupt):
        ttrainer.fit(cfg, interrupted, lambda: val(0), steps_per_epoch=4, device="cpu", dtype=torch.float32)
    m2, resumed, hist = ttrainer.fit(cfg, train, lambda: val(0), steps_per_epoch=4, device="cpu",
                                     dtype=torch.float32, resume_from=tmp_path / "b" / "best_model.npz")
    assert [h["epoch"] for h in hist["train"]] == [2]
    m_res = ttrainer.checkpoint_tree(m2, resumed)
    assert set(m_res) == set(m_full)
    for k in m_full:
        np.testing.assert_array_equal(m_res[k], m_full[k], err_msg=k)


def _jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_resumed_cli_runs_against_jax(tmp_path, capsys):
    """``train --resume`` through both CLIs at bf16, epochs 66-67 (2 steps
    each); the per-epoch figures within BF16_GAP."""
    from semantic_slam_master_tpu.cli import train_cli as jmain

    # The phase-21 recipe of chip_smoke.py (17 frames of one world, 8 pairs a
    # batch: 2 steps an epoch) at 64 px; the JAX CLI shards the batch over
    # the tests' 8 CPU devices.
    cfg = _write_config(tmp_path / "c.yaml", {"model": SMALL["model"], "dataset": {
        "synthetic_frames": 17, "synthetic_worlds": 1}, "training": {"save_dir": str(tmp_path)}})
    jmain.main(["--config", str(cfg), "--resume", str(ARTIFACT), "--epochs", "67", "--jsonl-log",
                str(tmp_path / "j.jsonl")])
    tcli.main(["--config", str(cfg), "--resume", str(STATE), "--epochs", "67", "--jsonl-log",
               str(tmp_path / "t.jsonl"), "--device", "cpu"])
    j, t = _jsonl(tmp_path / "j.jsonl"), _jsonl(tmp_path / "t.jsonl")
    assert [r["epoch"] for r in t] == [r["epoch"] for r in j] == [66, 67]
    gap = 0.0
    for a, b in zip(j, t):
        assert set(a) == set(b)
        for k in a:
            if k not in ("ts", "split", "epoch"):
                gap = max(gap, abs(b[k] - a[k]) / (abs(a[k]) + 0.01))
    with capsys.disabled():
        print(f"\n[bf16 gap of the resumed CLI runs, port vs JAX on the CPU: {gap:.3g}]")
    assert gap <= BF16_GAP
    assert t[0]["skipped"] == 0.0


def test_cli_trains_and_run_slam_loads_the_checkpoint(tmp_path):
    """``train --init-from`` the committed weights at a small size, one
    epoch with validation: ``best_model.npz`` is written with its meta, and
    the inference loader reads it (the optimiser keys ignored)."""
    from semantic_slam_master_tpu_torch.cli import run_slam_cli

    cfg = _write_config(tmp_path / "c.yaml", {**SMALL, "training": {"batch_size": 2, "val_interval": 1}})
    assert tcli.main(["--config", str(cfg), "--init-from", str(REPO / "weights" / "frontend_tiny.npz"),
                      "--epochs", "1", "--save-dir", str(tmp_path / "ck"), "--device", "cpu"]) == 0
    ckpt = tmp_path / "ck" / "best_model.npz"
    meta = json.loads((tmp_path / "ck" / "best_model.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["params_only"] is False and np.isfinite(meta["val_loss"])
    with np.load(ckpt) as z:
        assert "opt_state/adam_count" in z.files and int(z["step"]) == 2
    import argparse
    model = run_slam_cli.load_learned_frontend(argparse.Namespace(train_config=str(TINY), checkpoint=str(ckpt)), "cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


def test_cli_under_torchrun_on_a_mesh(tmp_path, capsys):
    """``train`` under ``torchrun`` as two gloo ranks (``mesh_data: 2``,
    ``--device cpu``): one epoch of two steps with validation; only the
    first rank logs (one ``done`` line, one JSONL record per split) and
    writes the checkpoint, whose arrays are the full ones. The epoch's train
    figures (both steps before any parameter moves: the warm-up's first
    learning rate is 0) equal a one-process run's of the same YAML within
    MESH_CLI_GAP in |mesh - one| / (|one| + 0.01). The validation after the
    second step is only held finite: at bf16 each rank rounds its weight
    gradients before their sum, Adam's first real step turns that into
    sign flips where a gradient is rounding noise, and the figures then
    part by up to 0.18 here; the multi-step equality, validation included,
    is held at f32 in tests/test_torch_parallel_dist.py."""
    import socket
    import subprocess
    import sys

    over = {"model": SMALL["model"], "dataset": {"synthetic_frames": 9, "synthetic_worlds": 1},
            "training": {"batch_size": 4, "epochs": 1, "val_interval": 1}}
    one = _write_config(tmp_path / "one.yaml", {**over, "training": {**over["training"], "save_dir": str(tmp_path / "o")}})
    mesh = _write_config(tmp_path / "mesh.yaml", {**over, "training": {
        **over["training"], "mesh_data": 2, "save_dir": str(tmp_path / "m")}})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(port), "-m", "semantic_slam_master_tpu_torch", "train", "--config", str(mesh),
         "--device", "cpu", "--jsonl-log", str(tmp_path / "m.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=180, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("done; best checkpoint") == 1
    assert tcli.main(["--config", str(one), "--device", "cpu", "--jsonl-log", str(tmp_path / "o.jsonl")]) == 0
    m, o = _jsonl(tmp_path / "m.jsonl"), _jsonl(tmp_path / "o.jsonl")
    assert [r["split"] for r in m] == [r["split"] for r in o] == ["train", "val"]
    gap = max(abs(m[0][k] - v) / (abs(v) + 0.01) for k, v in o[0].items() if k not in ("ts", "split"))
    with capsys.disabled():
        print(f"\n[train under torchrun (2 ranks) against one process, bf16 train figures: largest gap {gap:.3g}]")
    assert gap <= MESH_CLI_GAP and m[0]["skipped"] == 0.0
    assert all(np.isfinite(v) for k, v in m[1].items() if k not in ("ts", "split"))
    with np.load(tmp_path / "m" / "best_model.npz") as zm, np.load(tmp_path / "o" / "best_model.npz") as zo:
        assert set(zm.files) == set(zo.files)
        for k in zo.files:
            assert zm[k].shape == zo[k].shape, k


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--config", str(TINY), "--epochs", "1"])
