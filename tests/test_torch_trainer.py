"""Port parity of the frontend's train step (``train/trainer.py``): the
JAX trainer's jitted step and the port's on the same weights (flax's init,
converted) and the same batches (the JAX CLI's synthetic pair builder),
at tiny widths and f32 on the CPU, with the tiny recipe's losses
(GT-warp pairs, sub-patch offsets, localisation) and, in a second
config, a frozen backbone with hard negatives (safe radius, cross-image
negatives, hardest-negative margin).

Tolerances, and why (measured on this CPU: loss components within ~4e-7
relative, gradients within ~3.4e-6 of each leaf's largest entry):

- loss components and metrics within 2e-5 relative: sums run in other
  orders in the two frameworks;
- every gradient leaf within 3e-5 of the largest gradient entry of the
  step (leaves whose gradient is zero in exact arithmetic -- a bias ahead
  of a normalisation or a softmax -- hold only rounding noise);
- after two steps: batch statistics within 1e-5 relative; Adam's moments
  within 3e-5 (mu) and 1e-4 (nu, a square) of the moment's largest entry
  over all leaves, as the gradients;
  parameters within 0.5 of the summed learning rate everywhere, and
  within 1e-3 of it for 99% of the entries: Adam divides each gradient by
  its own magnitude, so where the gradient is rounding noise (the
  zero-gradient leaves above) its sign, and the step, is noise too.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.cli import train_cli as jcli
from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import trainer as jtrainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.ops.sampling import gather_patches
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


TINY = "configs/train_tiny_synthetic.yaml"
WIDTHS = {"input_size": 64, "num_keypoints": 12, "selector_hidden": 16, "descriptor_dim": 16, "refiner_hidden": 32,
          "refiner_layers": 3, "estimator_hidden": 16, "backbone_dim": 32, "backbone_depth": 2, "backbone_heads": 2,
          "backbone_pos_grid": 8}
CONFIGS = {
    "tiny_recipe": {"model": WIDTHS, "dataset": {"synthetic_frames": 5, "synthetic_worlds": 2},
                    "training": {"batch_size": 2, "epochs": 2}},
    "frozen_hard": {"model": WIDTHS, "dataset": {"synthetic_frames": 5, "synthetic_worlds": 2},
                    "training": {"batch_size": 2, "epochs": 2, "train_backbone": False},
                    "loss": {"hard_negatives": True, "safe_radius": 12.0, "weights": {
                        "desc": 8.0, "repeat": 0.3, "variance": 0.5, "peakiness": 0.1, "activation": 0.05, "edge": 0.3,
                        "sparsity": 0.3, "calibration": 0.3, "expected_error": 0.02, "localization": 1.0, "hard": 2.0}}},
}
STEPS_PER_EPOCH = 4
RTOL = 2e-5


def _states(name):
    jcfg = jconfig.load_config(TINY, CONFIGS[name])
    tcfg = tconfig.load_config(TINY, CONFIGS[name])
    model, state = jtrainer.create_train_state(jcfg, STEPS_PER_EPOCH)
    model = model.clone(dtype=jnp.float32)
    tm, ts = ttrainer.create_train_state(tcfg, STEPS_PER_EPOCH, dtype=torch.float32)
    tm.load_state_dict(convert.frontend_state_dict(jax.device_get(
        {"params": jtrainer.merge_params(state.trainable, state.frozen), "batch_stats": state.batch_stats})))
    return jcfg, tcfg, model, state, tm, ts


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    """Two train steps on both sides, then the two extra batches (NaN depth,
    no valid pair) on both, from the state after step 2."""
    jcfg, tcfg, model, state, tm, ts = _states(request.param)
    batches = list(jcli._synthetic_pair_batches(jcfg, 0)(1))[:2]
    tx = jtrainer.build_optimizer(jcfg, STEPS_PER_EPOCH)
    jstep = jtrainer.make_train_step(model, jcfg, tx)
    ttx = ttrainer.build_optimizer(tcfg, STEPS_PER_EPOCH, ttrainer.flax_order(ts.trainable))
    tstep = ttrainer.make_train_step(tm, tcfg, ttx)

    def grads(jstate, tstate, batch):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(trainable):
            v = {"params": jtrainer.merge_params(trainable, jstate.frozen), "batch_stats": jstate.batch_stats}
            return jtrainer._forward_pair(model, v, jb["rgb1"], jb["rgb2"], jcfg, extras=jb)[0].total

        jg = convert.flatten_tree({"params": jax.device_get(jax.jit(jax.grad(loss_fn))(jstate.trainable))})
        saved = {k: b.clone() for k, b in tstate.batch_stats.items()}
        tb = ttrainer.to_device(batch, "cpu")
        total = ttrainer._forward_pair(tm, tb["rgb1"], tb["rgb2"], tcfg, tb)[0].total
        names = list(tstate.trainable)
        g = torch.autograd.grad(total, [tstate.trainable[n] for n in names], allow_unused=True)
        with torch.no_grad():
            for k, b in tstate.batch_stats.items():
                b.copy_(saved[k])
        tg = convert.frontend_tree({n: torch.zeros_like(tstate.trainable[n]) if x is None else x
                                    for n, x in zip(names, g)})
        return jg, tg

    out = {"grads": grads(state, ts, batches[0]), "steps": [], "cfg": tcfg, "ttx": ttx}
    for b in batches:
        state, jo = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        ts, to = tstep(ts, ttrainer.to_device(b, "cpu"))
        out["steps"].append((jax.device_get(jo), {k: float(v) for k, v in to.items()}))
    out["after2"] = (convert.train_state_tree(jax.device_get(state)), ttrainer.checkpoint_tree(tm, ts))
    nan_batch = copy.deepcopy(batches[0])
    nan_batch["depth1"][0] = np.nan
    empty_batch = copy.deepcopy(batches[1])
    empty_batch["depth1"][:] = 0.0  # no warp is valid: no pair, no localisation
    for b in (nan_batch, empty_batch):
        before = ttrainer.checkpoint_tree(tm, ts)
        state, jo = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        ts, to = tstep(ts, ttrainer.to_device(b, "cpu"))
        out["steps"].append((jax.device_get(jo), {k: float(v) for k, v in to.items()}))
        out.setdefault("extra", []).append((before, convert.train_state_tree(jax.device_get(state)),
                                            ttrainer.checkpoint_tree(tm, ts)))
    jeval = jtrainer.make_eval_step(model, jcfg)(state, {k: jnp.asarray(v) for k, v in batches[0].items()})
    before = ttrainer.checkpoint_tree(tm, ts)
    teval = ttrainer.make_eval_step(tm, tcfg)(ts, ttrainer.to_device(batches[0], "cpu"))
    out["eval"] = (jax.device_get(jeval), {k: float(v) for k, v in teval.items()}, before,
                   ttrainer.checkpoint_tree(tm, ts))
    return request.param, out


def _close(t, j, what):
    for k in j:
        np.testing.assert_allclose(t[k], float(j[k]), rtol=RTOL, atol=RTOL * 1e-2, err_msg=f"{what}: {k}")


def test_loss_components_two_steps(run):
    name, out = run
    for i, (j, t) in enumerate(out["steps"][:2]):
        assert set(t) == set(j)
        assert not t["skipped"] and not bool(j["skipped"])
        _close(t, j, f"step {i}")
    if name == "frozen_hard":
        assert out["steps"][0][1]["hard"] > 0


def test_gradient_of_every_leaf(run):
    name, out = run
    jg, tg = out["grads"]
    assert set(jg) == set(tg)
    if name == "frozen_hard":
        assert not any(k.startswith("params/backbone") for k in jg)
    G = max(np.abs(v).max() for v in jg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=3e-5 * G, err_msg=k)


def test_state_after_two_steps(run):
    name, out = run
    jf, tf = out["after2"]
    assert set(jf) == set(tf)
    lr_sum = float(out["ttx"].schedule(0)) + float(out["ttx"].schedule(1))
    assert float(out["ttx"].schedule(0)) == 0.0 < lr_sum
    errs = []
    for k in jf:
        if jf[k].dtype.kind != "f":
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k.startswith("opt_state/"):
            moment = k.split("/")[1]
            scale = max(np.abs(v).max() for q, v in jf.items() if q.startswith(f"opt_state/{moment}/"))
            tol = 3e-5 if moment == "mu" else 1e-4
            np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=tol * scale, err_msg=k)
        else:
            errs.append(np.abs(tf[k].astype(np.float64) - jf[k]).ravel() / lr_sum)
    errs = np.concatenate(errs)
    assert errs.max() <= 0.5 and np.quantile(errs, 0.99) <= 1e-3, (errs.max(), np.quantile(errs, 0.99))
    if name == "frozen_hard":  # frozen backbone: weights untouched, statistics moved
        init = _states(name)[4].state_dict()
        for k, v in init.items():
            key = convert.flax_key(k, tuple(v.shape))
            if key.startswith("params/backbone"):
                a = v.numpy()
                np.testing.assert_array_equal(tf[key], convert.to_flax_layout(a) if key.endswith("/kernel") else a)
        assert not np.array_equal(tf["batch_stats/backbone/feature_norm/mean"], init["backbone.feature_norm.running_mean"].numpy())


def test_nan_depth_and_no_pair_batches(run):
    """NaN depth: the localisation term is guarded to 0 in the loss, but its
    gradient is NaN on both sides, so both skip the step: parameters,
    moments, counts and batch statistics stay, ``step`` moves. Depth 0
    everywhere: no pair, the desc fallback 0.1, a normal step."""
    _, out = run
    (nan_j, nan_t), (empty_j, empty_t) = out["steps"][2:]
    assert bool(nan_j["skipped"]) and nan_t["skipped"] == 1.0
    _close(nan_t, nan_j, "nan depth")
    before, jf, tf = out["extra"][0]
    for k in before:
        if k == "step":
            assert int(tf[k]) == int(jf[k]) == int(before[k]) + 1
        else:
            np.testing.assert_array_equal(tf[k], before[k], err_msg=k)
    assert not bool(empty_j["skipped"]) and empty_t["skipped"] == 0.0
    assert empty_t["desc"] == pytest.approx(0.1) and empty_t["localization"] == 0.0
    _close(empty_t, empty_j, "no pair")


def test_eval_step(run):
    _, out = run
    j, t, before, after = out["eval"]
    _close(t, j, "eval")
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_gather_patches_refuses_grad():
    img = torch.zeros(1, 32, 32, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        gather_patches(img, torch.full((1, 2, 2), 16.0), 10)


def test_convert_timm_state_dict_matches_the_jax_converter():
    """A timm-layout state dict built from a seed (tests/test_timm_convert.py's
    names and layouts, with a CLS token and a longer pos_embed) through both
    converters: the JAX params, converted by ``convert.py``, equal the
    port's state dict exactly, and it loads into ``ViTBackbone`` strictly."""
    from semantic_slam_master_tpu.models import backbone as jbackbone
    from semantic_slam_master_tpu_torch.models import backbone as tbackbone

    rng = np.random.default_rng(0)
    dim, depth, grid = 32, 2, 4

    def t(*shape):
        return torch.tensor(rng.normal(0, 0.05, size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(dim, 3, 16, 16), "patch_embed.proj.bias": t(dim), "cls_token": t(1, 1, dim),
          "reg_token": t(1, 4, dim), "pos_embed": t(1, 1 + grid * grid, dim), "norm.weight": t(dim),
          "norm.bias": t(dim)}
    for i in range(depth):
        for leaf, shape in (("norm1", (dim,)), ("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                            ("norm2", (dim,)), ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
            sd[f"blocks.{i}.{leaf}.weight"] = t(*shape)
            sd[f"blocks.{i}.{leaf}.bias"] = t(shape[0])
    jparams = jbackbone.convert_timm_state_dict({k: v.numpy() for k, v in sd.items()}, depth=depth, pos_grid=grid)
    want = {k[len("backbone."):]: v for k, v in convert.frontend_state_dict(
        {"params": {"backbone": jparams}}).items()}
    got = tbackbone.convert_timm_state_dict(sd, depth=depth, pos_grid=grid)
    assert set(want) <= set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tbackbone.ViTBackbone(embed_dim=dim, depth=depth, num_heads=2, pos_grid=grid).load_state_dict(got)
