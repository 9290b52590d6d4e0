"""Port parity of the segmenter trainer (``train/seg_trainer.py``) and
its CLI: the synthetic label batches bit-equal to the JAX builder's, two
train steps from flax's init (converted) against the JAX step at f32 on
the CPU, and ``train-segmenter --device cpu`` writing a checkpoint that
``run-slam --segmenter-checkpoint`` loads.

Tolerances, and why: the two frameworks sum convolutions and reductions
in other orders, so loss and accuracy agree within 1e-5 relative and the
parameters after two steps within 0.05 of the summed learning rate for
99.9% of the entries and 0.5 for all (Adam divides each gradient by its
magnitude: where GroupNorm makes a gradient direction zero in exact
arithmetic, the rounding noise in it sets the step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.train import seg_trainer as jst
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import run_slam_cli, train_segmenter_cli
from semantic_slam_master_tpu_torch.models import segmenter as tseg
from semantic_slam_master_tpu_torch.train import seg_trainer as tst


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread. Six test workers, each with one
    OpenMP thread per core, otherwise spin against each other (a 0.8 s
    test here took 70 s in the full parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_label_batches_bit_equal():
    a = jst.synthetic_label_batches(4, (48, 64), seed=3, num_frames=8)
    b = tst.synthetic_label_batches(4, (48, 64), seed=3, num_frames=8)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_two_steps_from_flax_init():
    hw, width, lr, steps = (32, 48), 8, 3e-3, 2
    jm = jseg.SemanticSegmenter(width=width, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))["params"]
    tx = optax.adamw(optax.cosine_decay_schedule(lr, steps), weight_decay=1e-4)
    jstep = jst.make_train_step(jm, tx)
    opt = tx.init(params)
    tm = tseg.SemanticSegmenter(width=width, dtype=torch.float32)
    tm.load_state_dict(convert.segmenter_state_dict(jax.device_get(params)))
    ttx = tst.make_optimizer(lr, steps)
    topt = ttx.init(dict(tm.named_parameters()))
    tstep = tst.make_train_step(tm, ttx)
    data = jst.synthetic_label_batches(2, hw, seed=0, num_frames=4)
    for _ in range(steps):
        batch = next(data)
        params, opt, jm_ = jstep(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        topt, tm_ = tstep(topt, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    lr_sum = float(ttx.schedule(0)) + float(ttx.schedule(1))
    jf = convert.flatten_tree({"params": jax.device_get(params)})
    tf = convert.segmenter_tree(tm.state_dict())
    assert set(jf) == set(tf)
    err = np.concatenate([np.abs(tf[k].astype(np.float64) - jf[k]).ravel() for k in jf]) / lr_sum
    assert err.max() <= 0.5 and np.quantile(err, 0.999) <= 0.05, (err.max(), np.quantile(err, 0.999))
    assert topt.adam_count == int(opt[0].count) == steps


def test_cli_writes_a_checkpoint_run_slam_loads(tmp_path, capsys):
    out = tmp_path / "seg"
    assert train_segmenter_cli.main(["--steps", "3", "--height", "32", "--width", "48", "--model-width", "8",
                                     "--output", str(out), "--device", "cpu"]) == 0
    assert "saved segmenter checkpoint" in capsys.readouterr().out
    path = tmp_path / "seg.npz"
    sd = tst.load_checkpoint(path)
    model = tseg.SemanticSegmenter(width=8)
    model.load_state_dict(sd)  # strict: every array present, none extra
    with torch.no_grad():
        logits = model(torch.rand(1, 32, 48, 3))
    assert logits.shape == (1, 32, 48, 6) and torch.isfinite(logits).all()
    import argparse
    full = tseg.SemanticSegmenter()
    tst.save_checkpoint(tmp_path / "full", full)
    loaded = run_slam_cli.load_segmenter(argparse.Namespace(segmenter_checkpoint=str(tmp_path / "full.npz")), "cpu")
    for k, v in full.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_segmenter_cli.main(["--steps", "1"])
