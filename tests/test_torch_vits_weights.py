"""The trained full-width ViT-S/16 frontend through the port: the committed
``weights/frontend_vits.npz`` (written by ``export_weights.py``) against
``artifacts/frontend_vits/best_model``, restored here once by the JAX
package (``trainer.restore_checkpoint``, which takes the params-only
checkpoint, into the state of ``configs/train_vits_synthetic.yaml``: 12
blocks x 384, 6 heads, 448 px, 500 keypoints, 128-d descriptors,
sub-patch refinement; its ``model.init`` jitted).

Tolerances: the file holds exactly the restored ``params`` and
``batch_stats``, 193 float32 arrays equal bit for bit; the CLI's loader
and the trainer's warm start load it parameter for parameter. Features
of 2 synthetic frames at scale 0.5, as tests/test_torch_checkpoints.py
holds the tiny frontend: at f32 keypoints slot by slot within 1e-3 px,
validity equal, descriptors and ``sem_weight`` within 1e-5; at bf16 (the
card's working dtype) each JAX keypoint has a port keypoint within 0.05
px for >= 95% of them, descriptor cosine >= 0.99 where a slot holds the
same keypoint."""

import argparse
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.cli import train_cli as jcli
from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import trainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import run_slam_cli
from semantic_slam_master_tpu_torch.cli import train_cli as tcli
from semantic_slam_master_tpu_torch.slam import tracking as ttracking
from semantic_slam_master_tpu_torch.train import config as tconfig
from semantic_slam_master_tpu_torch.train import trainer as ttrainer

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "train_vits_synthetic.yaml"
WARM_CONFIG = REPO / "configs" / "train_vits_synthetic_long.yaml"  # the stage-2 recipe
NPZ = REPO / "weights" / "frontend_vits.npz"
FRAMES = 2
# chip_smoke.py's phase-23/32 cut of the stage-2 recipe: 9 frames of one
# world, one batch of 8 pairs; its first VITS_CPU_PAIRS pairs are compared.
WARM_DATA = {"dataset": {"synthetic_frames": 9, "synthetic_worlds": 1}}
WARM_PAIRS = 2
BF16_GAP = 0.1  # as tests/test_torch_train_cli.py: |port - JAX| / (|JAX| + 0.01) at bf16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: six test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def restored():
    """(flax model, restored ``{"params", "batch_stats"}``) of the trained ViT-S/16."""
    cfg = jconfig.load_config(str(CONFIG))
    model = trainer.build_model(cfg)
    rng, init_rng = jax.random.split(jax.random.PRNGKey(cfg.training.seed))
    size = cfg.model.input_size
    variables = jax.jit(model.init)(init_rng, jnp.zeros((1, size, size, 3)))
    keys = trainer.TRAINABLE_WITH_BACKBONE if cfg.training.train_backbone else trainer.TRAINABLE
    trainable, frozen = trainer.split_params(variables["params"], keys)
    tx = trainer.build_optimizer(cfg, 1)
    state = trainer.TrainState(
        step=jnp.asarray(0, jnp.int32), trainable=trainable, frozen=frozen,
        batch_stats=variables.get("batch_stats", {}), opt_state=tx.init(trainable), rng=rng,
    )
    state, meta = trainer.restore_checkpoint(str(REPO / "artifacts" / "frontend_vits" / "best_model"), state)
    assert meta["epoch"] == 40 and meta["params_only"]
    return model, jax.device_get({"params": trainer.merge_params(state.trainable, state.frozen),
                                  "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def npz_arrays():
    with np.load(NPZ) as z:
        return {k: z[k] for k in z.files}


def _port_model(variables, dtype=torch.float32):
    m = tconfig.build_model(tconfig.load_model_config(CONFIG), dtype=dtype)
    m.load_state_dict(convert.frontend_state_dict(variables))
    return m.eval()


def _args(**kw):
    return argparse.Namespace(**{**dict(checkpoint=str(NPZ), train_config=str(CONFIG)), **kw})


def test_npz_equals_orbax_restore(restored, npz_arrays):
    want = convert.flatten_tree(restored[1])
    assert sorted(npz_arrays) == sorted(want)
    assert len(npz_arrays) == 193
    assert {k.split("/")[0] for k in npz_arrays} == {"params", "batch_stats"}
    assert sum(a.nbytes for a in npz_arrays.values()) == 94_615_436
    for k, a in npz_arrays.items():
        assert a.dtype == np.float32, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)


def test_cli_loader_equals_restore(restored):
    model = run_slam_cli.load_learned_frontend(_args(), torch.device("cpu"))
    sd, sd_ref = model.state_dict(), _port_model(restored[1], torch.bfloat16).state_dict()
    assert list(sd) == list(sd_ref)
    for k in sd:
        assert sd[k].dtype == sd_ref[k].dtype and torch.equal(sd[k], sd_ref[k]), k
    assert not model.training


def test_cli_loader_refuses_another_width(tmp_path):
    """The ViT-S file sized by the tiny config fails to load: strict shapes."""
    with pytest.raises(RuntimeError, match="state_dict"):
        run_slam_cli.load_learned_frontend(
            _args(train_config=str(REPO / "configs" / "train_tiny_synthetic.yaml")), torch.device("cpu"))


def test_warm_start_loads_the_weights(npz_arrays):
    """``train --init-from`` on the stage-2 recipe: ``restore_checkpoint``
    puts every array of the file into the full-width train state and keeps
    its fresh optimiser, step and key."""
    cfg = tconfig.load_config(WARM_CONFIG)
    model, state = ttrainer.create_train_state(cfg, 16, device="cpu", dtype=torch.float32)
    fresh = state.opt_state, state.step, np.array(state.rng)
    state, meta = ttrainer.restore_checkpoint(NPZ, model, state)
    assert meta["params_only"]
    assert state.opt_state is fresh[0] and state.step == fresh[1] and np.array_equal(state.rng, fresh[2])
    got = convert.frontend_tree(model.state_dict())
    assert sorted(got) == sorted(npz_arrays)
    for k, a in npz_arrays.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.make_sequence(num_frames=FRAMES, scale=0.5)
    fr = [seq.frame(i) for i in range(FRAMES)]
    return (np.stack([f["rgb"] for f in fr]).astype(np.float32),
            np.stack([f["depth"] for f in fr]).astype(np.float32))


def _jax_features(restored, frames, dtype):
    model, variables = restored
    m = model.clone(dtype=dtype)
    rgb, depth = frames
    return jax.device_get(jax.jit(lambda r, d: jtracking.extract_learned_features(m, variables, r, d))(
        jnp.asarray(rgb), jnp.asarray(depth)))


def _port_features(frames, dtype):
    model = _port_model(NPZ, dtype)
    rgb, depth = frames
    return ttracking.extract_learned_features(model, torch.from_numpy(rgb), torch.from_numpy(depth))


def test_trained_vits_features_f32(restored, frames):
    ref = _jax_features(restored, frames, jnp.float32)
    got = _port_features(frames, torch.float32)
    assert np.abs(got.xy.numpy() - ref.xy).max() <= 1e-3
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_allclose(got.desc.numpy(), ref.desc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sem_weight.numpy(), ref.sem_weight, rtol=0, atol=1e-5)
    # The trained offset head moves keypoints off the 16 px patch centres.
    assert (np.abs(((ref.xy - 8.0) / 16.0) - np.round((ref.xy - 8.0) / 16.0)) > 0.01).mean() > 0.5


def test_trained_vits_features_bf16(restored, frames):
    ref = _jax_features(restored, frames, jnp.bfloat16)
    got = _port_features(frames, torch.bfloat16)
    a, b = ref.xy, got.xy.numpy()
    nearest = np.sqrt(((a[:, :, None] - b[:, None]) ** 2).sum(-1)).min(-1)
    assert (nearest <= 0.05).mean() >= 0.95, (nearest <= 0.05).mean()
    same = np.abs(a - b).max(-1) <= 0.05
    cos = (got.desc.numpy() * ref.desc).sum(-1)
    assert same.mean() >= 0.2 and cos[same].min() >= 0.99, (same.mean(), cos[same].min())


def test_warm_start_first_forward_against_jax(restored, capsys):
    """The stage-2 warm start's first forward (train mode, bf16) on the
    first WARM_PAIRS pairs of chip_smoke.py's cut of the recipe: the port
    from ``weights/frontend_vits.npz`` through ``restore_checkpoint``, JAX
    from the orbax restore. Every figure within BF16_GAP, ``hard``
    included, and JAX's figures are chip_smoke.py's VITS_WARM_JAX, which
    phase 32 holds the card to."""
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="not_main")
    assert smoke["VITS_FRAMES"] == WARM_DATA["dataset"]["synthetic_frames"] and smoke["VITS_CPU_PAIRS"] == WARM_PAIRS
    jcfg, tcfg = jconfig.load_config(str(WARM_CONFIG), WARM_DATA), tconfig.load_config(WARM_CONFIG, WARM_DATA)
    jb = next(iter(jcli._synthetic_pair_batches(jcfg, 0)(1)))
    tb = next(iter(tcli._synthetic_pair_batches(tcfg, 0)(1)))
    assert all(np.array_equal(jb[k], tb[k]) for k in jb)
    half = {k: v[:WARM_PAIRS] for k, v in jb.items()}

    model, variables = restored
    bundle, metrics, _ = jax.jit(lambda v, b: trainer._forward_pair(model, v, b["rgb1"], b["rgb2"], jcfg, extras=b))(
        variables, {k: jnp.asarray(v) for k, v in half.items()})
    want = smoke["forward_figures"](bundle, metrics)

    tm, state = ttrainer.create_train_state(tcfg, 16, device="cpu")
    ttrainer.restore_checkpoint(NPZ, tm, state)
    b = ttrainer.to_device(half, "cpu")
    with torch.no_grad():
        got = smoke["forward_figures"](*ttrainer._forward_pair(tm, b["rgb1"], b["rgb2"], tcfg, b))
    assert set(got) == set(want) and "hard" in got
    assert all(np.isfinite(v) for v in got.values())
    gap, key = smoke["figure_gap"](got, want)
    with capsys.disabled():
        print(f"\n[warm-start forward, port vs JAX on the CPU at bf16: largest gap {gap:.4g} at {key}; "
              f"JAX {want}]")
    assert gap <= BF16_GAP, (key, got[key], want[key])
    assert set(smoke["VITS_WARM_JAX"]) == set(want)
    for k, v in want.items():
        assert abs(smoke["VITS_WARM_JAX"][k] - v) <= 1e-6 * (abs(v) + 0.01), (k, v)
