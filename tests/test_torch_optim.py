"""Port parity of the trainers' optimisers (``train/optim.py``) against
optax on the CPU: the frontend trainer's ``chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` from ``trainer.build_optimizer``
and the segmenter trainer's ``adamw(cosine_decay_schedule(lr, n), 1e-4)``,
over 5 steps on a small tree of parameters with gradients drawn from a
seed. The frontend run covers the learning-rate-0 first step of a warm-up
from 0 (the parameters stay, the moments move), a step whose gradient norm
is above the clip and is scaled down, and a step with a NaN gradient that
the trainer's rule skips (parameters, moments and both counts stay).

Tolerances, and why: both sides compute in f32, in the same order of
operations, but XLA may fuse a multiply-add into one FMA and evaluates
``cos`` and ``pow`` with its own routines, so parameters and moments agree
within 1e-6 of the largest entry of their leaf (the learning rate within 1e-6 of
its peak: near the end of the cosine, 1 + cos cancels); counts
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import trainer as jtrainer
from semantic_slam_master_tpu_torch.train import config as tconfig
from semantic_slam_master_tpu_torch.train import optim
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


SHAPES = {"a": {"bias": (5,), "kernel": (4, 5)}, "b": {"scale": (3,)}, "c": (2, 3, 3)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _run(tx_j, tx_t, grads_per_step):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in _flat(SHAPES).items()}
    jp = jax.tree.map(jnp.asarray, _tree(p0))
    jopt = tx_j.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = tx_t.init(tp)
    jupdate = jax.jit(tx_j.update)
    history = []
    for g in grads_per_step:
        jg = jax.tree.map(jnp.asarray, _tree(g))
        updates, new_opt = jupdate(jg, jopt, jp)
        ok = all(bool(jnp.all(jnp.isfinite(x))) for x in jax.tree.leaves(jg))
        if ok:  # the trainer's step-level mask
            jp, jopt = optax.apply_updates(jp, updates), new_opt
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        new_tp, new_topt, norm = tx_t.update(tg, topt, tp)
        if all(bool(torch.isfinite(x).all()) for x in tg.values()):
            tp, topt = new_tp, new_topt
        history.append((jax.device_get(jp), jax.device_get(jopt), {k: v.clone() for k, v in tp.items()}, topt, float(norm)))
    return history


def _compare(history, adam_index):
    for jp, jopt, tp, topt, _ in history:
        jf = _flat(jp)
        for k in jf:
            np.testing.assert_allclose(tp[k].numpy(), jf[k], rtol=1e-6, atol=1e-7)
        adam = jopt[adam_index[0]][adam_index[1]] if adam_index else jopt[0]
        sched = jopt[adam_index[0]][2] if adam_index else jopt[2]
        assert int(adam.count) == topt.adam_count and int(sched.count) == topt.schedule_count
        for name, moment in (("mu", topt.mu), ("nu", topt.nu)):
            jm = _flat(getattr(adam, name))
            for k in jm:
                np.testing.assert_allclose(moment[k].numpy(), jm[k], rtol=1e-6, atol=1e-6 * np.abs(jm[k]).max())


def _grads(scales, nan_at=None):
    rng = np.random.default_rng(1)
    out = []
    for i, s in enumerate(scales):
        g = {k: (s * rng.normal(size=sh)).astype(np.float32) for k, sh in _flat(SHAPES).items()}
        if i == nan_at:
            g["a.bias"][2] = np.nan
        out.append(g)
    return out


def test_frontend_optimizer_five_steps():
    cfg_j = jconfig.load_config(None, {"training": {"epochs": 2, "warmup_epochs": 1, "lr": 0.01, "grad_clip": 1.0}})
    cfg_t = tconfig.load_config(None, {"training": {"epochs": 2, "warmup_epochs": 1, "lr": 0.01, "grad_clip": 1.0}})
    tx_j = jtrainer.build_optimizer(cfg_j, 3)
    tx_t = ttrainer.build_optimizer(cfg_t, 3, sorted(_flat(SHAPES)))
    # step 0: lr 0; step 1: norm ~ 20 > clip; step 2: NaN, skipped; 3-4: below the clip.
    grads = _grads([0.1, 3.0, 0.1, 0.05, 0.1], nan_at=2)
    history = _run(tx_j, tx_t, grads)
    _compare(history, (1, 0))
    rng = np.random.default_rng(0)
    start = {k: rng.normal(size=s).astype(np.float32) for k, s in _flat(SHAPES).items()}
    for k in start:  # the first step moved no parameter
        np.testing.assert_array_equal(history[0][2][k].numpy(), start[k])
    assert history[1][4] > 1.0 > history[3][4]
    assert history[2][3].adam_count == history[1][3].adam_count == 2
    assert history[4][3].schedule_count == 4


def test_segmenter_optimizer_five_steps():
    tx_j = optax.adamw(optax.cosine_decay_schedule(3e-3, 5), weight_decay=1e-4)
    tx_t = optim.AdamW(optim.cosine_decay_schedule(3e-3, 5), 1e-4)
    history = _run(tx_j, tx_t, _grads([1.0, 0.5, 2.0, 1.0, 0.1]))
    _compare(history, None)


@pytest.mark.parametrize("warmup,total,init", [(15, 1280, 0.0), (1, 2, 3e-4), (48, 128, 0.0)])
def test_warmup_cosine_schedule(warmup, total, init):
    js = jax.jit(optax.warmup_cosine_decay_schedule(init, 3e-4, warmup, total, 1e-6))
    ts = optim.warmup_cosine_decay_schedule(init, 3e-4, warmup, total, 1e-6)
    counts = sorted(set(range(0, 40)) | {warmup - 1, warmup, warmup + 1, total - 1, total, total + 7, 2275})
    for c in counts:
        np.testing.assert_allclose(ts(c), float(js(jnp.asarray(c, jnp.int32))), rtol=0, atol=1e-6 * 3e-4)
    assert ts(0) == np.float32(init)


def test_cosine_schedule():
    js = jax.jit(optax.cosine_decay_schedule(3e-3, 300))
    ts = optim.cosine_decay_schedule(3e-3, 300)
    for c in range(0, 320, 3):
        np.testing.assert_allclose(ts(c), float(js(jnp.asarray(c, jnp.int32))), rtol=0, atol=1e-6 * 3e-3)
