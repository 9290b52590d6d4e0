"""The committed ``weights/segmenter.npz`` and ``weights/frontend_tiny.npz``
(written by ``export_weights.py``) against the orbax checkpoints they came
from, restored here by the JAX package: ``artifacts/segmenter/best_model``
(``seg_trainer.load_checkpoint``) and ``artifacts/frontend_tiny/
best_model`` (``trainer.restore_checkpoint`` into the state of
``configs/train_tiny_synthetic.yaml``, its ``model.init`` jitted).

Tolerances: none. Each file holds exactly the restored ``params`` and
``batch_stats`` (no optimizer state, PRNG key or step), float32 and equal
array for array; the port's models built from a file equal those built
from the restored trees, parameter for parameter and output for output.
The CLI's loaders are strict: a missing or an extra array fails."""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import seg_trainer, trainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import run_slam_cli

REPO = Path(__file__).resolve().parents[1]
TINY_CONFIG = REPO / "configs" / "train_tiny_synthetic.yaml"
NPZ = {"segmenter": REPO / "weights" / "segmenter.npz",
       "frontend_tiny": REPO / "weights" / "frontend_tiny.npz"}


def _restore_frontend_tiny():
    cfg = jconfig.load_config(str(TINY_CONFIG))
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
    state, _ = trainer.restore_checkpoint(str(REPO / "artifacts" / "frontend_tiny" / "best_model"), state)
    return jax.device_get({"params": trainer.merge_params(state.trainable, state.frozen),
                           "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def restored():
    return {
        "segmenter": {"params": jax.device_get(seg_trainer.load_checkpoint(
            str(REPO / "artifacts" / "segmenter" / "best_model")))},
        "frontend_tiny": _restore_frontend_tiny(),
    }


@pytest.mark.parametrize("name,n_arrays", [("segmenter", 20), ("frontend_tiny", 89)])
def test_npz_equals_orbax_restore(restored, name, n_arrays):
    want = convert.flatten_tree(restored[name])
    with np.load(NPZ[name]) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    assert len(got) == n_arrays
    assert all(k.split("/")[0] in ("params", "batch_stats") for k in got)
    for k, a in got.items():
        assert a.dtype == np.float32, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)


def _args(**kw):
    base = dict(segmenter_checkpoint=None, checkpoint=None, train_config=str(TINY_CONFIG))
    return argparse.Namespace(**{**base, **kw})


def test_port_segmenter_from_npz_equals_restore(restored):
    from semantic_slam_master_tpu_torch.models import segmenter as tseg

    model = run_slam_cli.load_segmenter(_args(segmenter_checkpoint=str(NPZ["segmenter"])), torch.device("cpu"))
    ref = tseg.SemanticSegmenter()
    ref.load_state_dict(convert.segmenter_state_dict(restored["segmenter"]))
    ref.eval()
    for (ka, a), (kb, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 96, 3), dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(model(x, full_res=False), ref(x, full_res=False))


def test_port_frontend_tiny_from_npz_equals_restore(restored):
    from semantic_slam_master_tpu_torch.train import config as tconfig

    model = run_slam_cli.load_learned_frontend(_args(checkpoint=str(NPZ["frontend_tiny"])), torch.device("cpu"))
    ref = tconfig.build_model(tconfig.load_model_config(TINY_CONFIG))
    ref.load_state_dict(convert.frontend_state_dict(restored["frontend_tiny"]))
    ref.eval()
    sd, sd_ref = model.state_dict(), ref.state_dict()
    assert list(sd) == list(sd_ref)
    for k in sd:
        assert torch.equal(sd[k], sd_ref[k]), k
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 96, 128, 3), dtype=np.float32))
    with torch.no_grad():
        a, b = model(x), ref(x)
    assert torch.equal(a.keypoints_px, b.keypoints_px) and torch.equal(a.descriptors, b.descriptors)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_cli_loaders_are_strict(tmp_path, change):
    for name, kw, load in (("segmenter", "segmenter_checkpoint", run_slam_cli.load_segmenter),
                           ("frontend_tiny", "checkpoint", run_slam_cli.load_learned_frontend)):
        with np.load(NPZ[name]) as z:
            arrays = {k: z[k] for k in z.files}
        if change == "missing":
            arrays.pop(sorted(arrays)[-1])
        else:
            arrays["params/unused/kernel"] = np.zeros((2, 2), np.float32)
        bad = tmp_path / f"{name}_{change}.npz"
        np.savez(bad, **arrays)
        with pytest.raises(RuntimeError, match="state_dict"):
            load(_args(**{kw: str(bad)}), torch.device("cpu"))
