"""The port's mesh across processes: ranks spawned as CPU processes under
gloo (``torch.distributed``), held against the port in one process and
against the JAX package (whose mesh runs on the conftest's 8 virtual
devices in this process).

- Tensor parallelism on the tiny ViT of ``tests/test_tp_equivalence.py``
  (embed 64, depth 2, 2 heads, f32, batch 8) at a 2 x 2 mesh and a 1 x 4
  mesh, where the 2 heads cannot split over the 'model' ranks: the
  forward and every parameter gradient of sum(feats^2) / size over the
  global batch equal the replicated port model's and JAX's at JAX's own
  tolerances (rtol 2e-4, atol 1e-5 forward; 5e-4, 1e-5 gradients). That
  loss's gradient below the final LayerNorm cancels to rounding noise
  (~1e-7 of the largest entry), so the gradients of a second loss, a
  fixed random projection sum(feats * R) / size, are held leaf by leaf
  at the same rtol with the atol taken relative to each leaf's largest
  entry.
- Two train steps at ``data=2`` of the tiny recipe (GT-warp pairs,
  sub-patch offsets, localisation) with the backbone trained, BatchNorm in
  training mode and hard negatives (safe radius, cross-image negatives,
  margin), batch 4: the loss components of each step, every parameter,
  Adam's moments and the BatchNorm statistics against the one-process
  port step and JAX's step over a data=2 mesh, at the tolerances of
  ``tests/test_torch_trainer.py`` (f32): components within 2e-5 relative,
  statistics within 1e-5 relative, moments within 3e-5 (mu) and 1e-4 (nu)
  of the moment's largest entry, parameters within 0.5 of the summed
  learning rate and 99% of entries within 1e-3 of it; and the first
  batch's gradient, summed over the ranks, within 3e-5 of its largest
  entry of the one-process gradient (the clip rescales a gradient of
  norm above 1, so the steps alone would not see a gradient counted
  twice).
- The fleet over ``data=2`` equals the one-process fleet bit for bit.
- A 2 x 2 mesh ``fit`` mirroring ``__graft_entry__.py::dryrun_multichip``
  (its tiny shapes, sub-patch refinement, localisation weight 0.5, no
  warm-up): a finite loss, ``step == 1``, and a full-array checkpoint that
  a one-rank run restores, equal to a one-rank ``fit`` of the same batch
  at the tolerances above.

Each rank sets one intra-op thread. Each collective has a timeout and each
test a join timeout of its own, so a hung collective fails the test.
"""

import datetime
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.core import prng
from semantic_slam_master_tpu_torch.models.backbone import ViTBackbone
from semantic_slam_master_tpu_torch.parallel import mesh as tmesh
from semantic_slam_master_tpu_torch.parallel import tp
from semantic_slam_master_tpu_torch.slam import parallel as tfleet
from semantic_slam_master_tpu_torch.slam import system as tsystem
from semantic_slam_master_tpu_torch.train import config as tconfig
from semantic_slam_master_tpu_torch.train import trainer as ttrainer

# Spawned ranks import this module: JAX is imported inside the fixtures,
# in the test process only.

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs" / "train_tiny_synthetic.yaml")
COLLECTIVE_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 90


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_main(fn, rank, world, out_dir):
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out_dir / 'store'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        args = torch.load(out_dir / "args.pt", weights_only=False)
        torch.save(fn(rank, *args), out_dir / f"rank{rank}.pt")
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, fn, *args):
    """``fn(rank, *args)`` on ``world`` gloo ranks; their results in rank
    order. The arguments go through a file: through the start pipe, a
    start blocks until the rank has imported enough to read them."""
    torch.save(args, tmp_path / "args.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(tmp_path))) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (tmp_path / f"rank{r}.err").read_text() for r in range(world) if (tmp_path / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s; errors {errors}"
    assert all(p.exitcode == 0 for p in procs), ([p.exitcode for p in procs], errors)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _flax(tensors):
    """Port tensors by name -> numpy arrays by flax path, in flax's layout
    (a bare backbone's top-level leaves have no module in their path)."""
    return {k.replace("//", "/"): v for k, v in convert.frontend_tree(dict(tensors)).items()}


# --------------------------------------------------------------------------
# Tensor parallelism on the tiny ViT
# --------------------------------------------------------------------------

VIT = dict(embed_dim=64, depth=2, num_heads=2, num_registers=1, pos_grid=4, dtype=torch.float32)


def _vit_grads(model, images, probe, mesh):
    """The gathered features and the gradients of both losses, each summed
    over the mesh and whole."""
    feats = tmesh.gather(model(images), mesh.data_group)
    names = [k for k, _ in model.named_parameters()]
    out = {}
    for name, loss in (("square", torch.sum(feats**2) / feats.numel()),
                       ("probe", torch.sum(feats * torch.from_numpy(probe)) / feats.numel())):
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()), retain_graph=True)))
        sharded = tp.sharded_names(grads)
        grads = tmesh.reduce_grads(mesh, grads, [k for k in names if k not in sharded])
        out[name] = _flax(tp.unshard_tree(grads, mesh))
    return feats.detach().numpy(), out


def _vit_rank(rank, num_model, state_dict, images, probe):
    mesh = tmesh.make_mesh(num_model=num_model)
    model = ViTBackbone(**VIT)
    model.load_state_dict(state_dict)
    tp.shard_module(model, mesh)
    feats, grads = _vit_grads(model, tmesh.shard_batch(mesh, torch.from_numpy(images)), probe, mesh)
    return {"feats": feats, "grads": grads, "mesh": (mesh.num_data, mesh.num_model)}


@pytest.fixture(scope="module")
def vit_reference():
    import jax
    import jax.numpy as jnp

    from semantic_slam_master_tpu.models.backbone import ViTBackbone as JViT

    jm = JViT(embed_dim=64, depth=2, num_heads=2, num_registers=1, pos_grid=4, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(8, 64, 64, 3)).astype(np.float32)
    probe = rng.normal(size=(8, 4, 4, 64)).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    losses = {"square": lambda f: jnp.sum(f.astype(jnp.float32) ** 2) / f.size,
              "probe": lambda f: jnp.sum(f * probe) / f.size}
    jgrad = {name: convert.flatten_tree({"params": jax.device_get(jax.jit(jax.grad(
        lambda v, x: fn(jm.apply(v, x))))(variables, images))["params"]}) for name, fn in losses.items()}
    jout = np.asarray(jax.jit(jm.apply)(variables, images))
    state_dict = convert.frontend_state_dict(jax.device_get(variables))
    model = ViTBackbone(**VIT)
    model.load_state_dict(state_dict)
    tout, tgrad = _vit_grads(model, torch.from_numpy(images), probe, tmesh.Mesh())
    return images, probe, state_dict, (jout, jgrad), (tout, tgrad)


@pytest.mark.parametrize("num_model", [2, 4])
def test_tp_forward_and_grads_match_replicated_and_jax(vit_reference, num_model, tmp_path):
    images, probe, state_dict, (jout, jgrad), (tout, tgrad) = vit_reference
    got = _spawn(tmp_path, 4, _vit_rank, num_model, state_dict, images, probe)
    assert got[0]["mesh"] == (4 // num_model, num_model)
    for r in got:  # every rank ends with the whole result
        for want in (tout, jout):
            np.testing.assert_allclose(r["feats"], want, rtol=2e-4, atol=1e-5)
        for name, grads in r["grads"].items():
            assert set(grads) == set(tgrad[name]) == set(jgrad[name])
            for k, j in jgrad[name].items():
                scale = np.abs(j).max() if name == "probe" else 1.0
                for want in (tgrad[name][k], j):
                    np.testing.assert_allclose(grads[k] / scale, want / scale, rtol=5e-4, atol=1e-5,
                                               err_msg=f"{name}: {k}")


# --------------------------------------------------------------------------
# Two data-parallel train steps of the tiny recipe
# --------------------------------------------------------------------------

WIDTHS = {"input_size": 64, "num_keypoints": 12, "selector_hidden": 16, "descriptor_dim": 16, "refiner_hidden": 32,
          "refiner_layers": 3, "estimator_hidden": 16, "backbone_dim": 32, "backbone_depth": 2, "backbone_heads": 2,
          "backbone_pos_grid": 8}
DP = {"model": WIDTHS, "dataset": {"synthetic_frames": 9, "synthetic_worlds": 1},
      "training": {"batch_size": 4, "epochs": 2, "train_backbone": True},
      "loss": {"hard_negatives": True, "safe_radius": 12.0, "weights": {
          "desc": 8.0, "repeat": 0.3, "variance": 0.5, "peakiness": 0.1, "activation": 0.05, "edge": 0.3,
          "sparsity": 0.3, "calibration": 0.3, "expected_error": 0.02, "localization": 1.0, "hard": 2.0}}}
STEPS_PER_EPOCH = 4
RTOL = 2e-5


def _dp_steps(cfg, state_dict, batches, mesh):
    model, state = ttrainer.create_train_state(cfg, STEPS_PER_EPOCH, dtype=torch.float32)
    model.load_state_dict(state_dict)
    tx = ttrainer.to_mesh(model, state, cfg, STEPS_PER_EPOCH, mesh)
    names = list(state.trainable)
    saved = {k: b.clone() for k, b in state.batch_stats.items()}
    b = ttrainer.to_device(tmesh.shard_batch(mesh, batches[0]), "cpu")
    total = ttrainer._forward_pair(model, b["rgb1"], b["rgb2"], cfg, b, mesh)[0].total
    grads = dict(zip(names, torch.autograd.grad(total, [state.trainable[k] for k in names], allow_unused=True)))
    grads = tmesh.reduce_grads(mesh, {k: torch.zeros_like(state.trainable[k]) if g is None else g
                                      for k, g in grads.items()}, names)
    with torch.no_grad():
        for k, v in state.batch_stats.items():
            v.copy_(saved[k])
    step = ttrainer.make_train_step(model, cfg, tx, mesh)
    outs = []
    for b in batches:
        state, out = step(state, ttrainer.to_device(tmesh.shard_batch(mesh, b), "cpu"))
        outs.append({k: float(v) for k, v in out.items()})
    return {"outs": outs, "tree": ttrainer.checkpoint_tree(model, state, mesh=mesh), "lr": tx.schedule,
            "grads": _flax(grads)}


def _dp_rank(rank, state_dict, batches):
    cfg = tconfig.load_config(TINY, {**DP, "training": {**DP["training"], "mesh_data": 2}})
    out = _dp_steps(cfg, state_dict, batches, tmesh.make_mesh(cfg.training.mesh_data, cfg.training.mesh_model))
    return {"outs": out["outs"], "tree": out["tree"], "grads": out["grads"]}


@pytest.fixture(scope="module")
def dp_reference():
    import jax
    import jax.numpy as jnp

    from semantic_slam_master_tpu.cli import train_cli as jcli
    from semantic_slam_master_tpu.parallel import mesh as jmesh, tp as jtp
    from semantic_slam_master_tpu.train import config as jconfig
    from semantic_slam_master_tpu.train import trainer as jtrainer

    jcfg = jconfig.load_config(TINY, DP)
    batches = list(jcli._synthetic_pair_batches(jcfg, 0)(1))[:2]
    # jtrainer.create_train_state with a jitted init (eager, it takes ~25 s)
    model = jtrainer.build_model(jcfg)
    rng, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.training.seed))
    size = jcfg.model.input_size
    variables = jax.jit(model.init)(init_rng, jnp.zeros((1, size, size, 3)))
    trainable, frozen = jtrainer.split_params(variables["params"], jtrainer.TRAINABLE_WITH_BACKBONE)
    state = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), trainable=trainable, frozen=frozen,
                                batch_stats=variables["batch_stats"], rng=rng,
                                opt_state=jtrainer.build_optimizer(jcfg, STEPS_PER_EPOCH).init(trainable))
    model = model.clone(dtype=jnp.float32)
    state_dict = convert.frontend_state_dict(jax.device_get(
        {"params": jtrainer.merge_params(state.trainable, state.frozen), "batch_stats": state.batch_stats}))
    mesh = jmesh.make_mesh(2, 1, jax.devices()[:2])
    state = jtp.shard_tree(state, mesh)
    jstep = jtrainer.make_train_step(model, jcfg, jtrainer.build_optimizer(jcfg, STEPS_PER_EPOCH), mesh)
    jouts = []
    for b in batches:
        state, o = jstep(state, jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        jouts.append({k: float(v) for k, v in jax.device_get(o).items()})
    jtree = convert.train_state_tree(jax.device_get(state))
    one = _dp_steps(tconfig.load_config(TINY, DP), state_dict, batches, tmesh.Mesh())
    return state_dict, batches, (jouts, jtree), one


def _close_states(got, want, lr_sum, what):
    assert set(got) == set(want)
    errs = []
    for k in want:
        if want[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{what}: {k}")
        elif k.startswith("opt_state/"):
            moment = k.split("/")[1]
            scale = max(np.abs(v).max() for q, v in want.items() if q.startswith(f"opt_state/{moment}/"))
            tol = 3e-5 if moment == "mu" else 1e-4
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * scale, err_msg=f"{what}: {k}")
        else:
            errs.append(np.abs(got[k].astype(np.float64) - want[k]).ravel() / lr_sum)
    errs = np.concatenate(errs)
    assert errs.max() <= 0.5 and np.quantile(errs, 0.99) <= 1e-3, (what, errs.max(), np.quantile(errs, 0.99))


def test_dp_train_steps_match_one_process_and_jax(dp_reference, tmp_path):
    state_dict, batches, (jouts, jtree), one = dp_reference
    got = _spawn(tmp_path, 2, _dp_rank, state_dict, batches)
    lr_sum = float(one["lr"](0)) + float(one["lr"](1))
    assert lr_sum > 0
    for r in got:
        for i, (o, t, j) in enumerate(zip(r["outs"], one["outs"], jouts)):
            assert not o["skipped"] and set(o) == set(t) == set(j)
            assert o["hard"] > 0
            for k in j:
                for want, who in ((t[k], "one process"), (j[k], "JAX")):
                    np.testing.assert_allclose(o[k], want, rtol=RTOL, atol=RTOL * 1e-2, err_msg=f"step {i} {k} vs {who}")
        G = max(np.abs(v).max() for v in one["grads"].values())
        assert set(r["grads"]) == set(one["grads"])
        for k, want in one["grads"].items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=0, atol=3e-5 * G, err_msg=k)
        _close_states(r["tree"], one["tree"], lr_sum, "one process")
        _close_states(r["tree"], jtree, lr_sum, "JAX")
        assert np.abs(r["tree"]["batch_stats/backbone/feature_norm/mean"]).max() > 0  # moved from 0


# --------------------------------------------------------------------------
# The fleet over data=2
# --------------------------------------------------------------------------

FLEET_CFG = dict(num_landmarks=128, num_hypotheses=16, min_inliers=8)


def _fleet_rank(rank, feats, keys, cam):
    feats = tsystem.FrameFeatures(*[torch.from_numpy(x) for x in feats])
    out = tfleet.run_slam_fleet(keys, feats, cam, tsystem.SlamConfig(**FLEET_CFG), tmesh.make_mesh(2))
    return tuple(out)


def test_fleet_over_two_ranks_equals_one_process(tmp_path):
    import jax

    from semantic_slam_master_tpu.core.camera import TUM_FR2
    from test_fleet_slam import _fake_features

    S, F = 8, 6
    feats = convert.frame_features(_fake_features(jax.random.PRNGKey(0), S, F))
    keys, cam = prng.split(prng.PRNGKey(1), S), convert.camera(TUM_FR2)
    want = tfleet.run_slam_fleet(keys, feats, cam, tsystem.SlamConfig(**FLEET_CFG))
    got = _spawn(tmp_path, 2, _fleet_rank, tuple(x.numpy() for x in feats), keys, cam)
    for r in got:
        for a, b in zip(r, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# A 2 x 2 dry run through fit, restored in one rank
# --------------------------------------------------------------------------


def _dryrun_config(save_dir, mesh_data, mesh_model):
    cfg = tconfig.Config()
    m = cfg.model
    m.input_size, m.backbone_depth, m.backbone_dim, m.backbone_heads = 64, 2, 64, 2
    m.selector_hidden, m.refiner_hidden, m.refiner_layers = 32, 64, 3
    m.descriptor_dim, m.estimator_hidden, m.num_keypoints = 32, 32, 16
    m.subpatch_refine = True
    cfg.loss.weights = dict(cfg.loss.weights, localization=0.5)
    t = cfg.training
    t.warmup_epochs, t.epochs, t.val_interval, t.save_dir = 0, 1, 1, str(save_dir)
    t.mesh_data, t.mesh_model = mesh_data, mesh_model
    return cfg


def _dryrun_batch(batch_size=4):
    rng = np.random.default_rng(0)
    K = np.array([[[80.0, 0, 32], [0, 80, 32], [0, 0, 1]]], np.float32)
    K2 = np.array([[[80.0, 0, 35], [0, 80, 29], [0, 0, 1]]], np.float32)
    return {
        "rgb1": rng.normal(size=(batch_size, 64, 64, 3)).astype(np.float32),
        "rgb2": rng.normal(size=(batch_size, 64, 64, 3)).astype(np.float32),
        "depth1": np.full((batch_size, 64, 64), 2.0, np.float32),
        "K": np.repeat(K, batch_size, axis=0),
        "K2": np.repeat(K2, batch_size, axis=0),
        "rel_pose": np.repeat(np.eye(4, dtype=np.float32)[None], batch_size, axis=0),
    }


def _fit(cfg):
    batch = _dryrun_batch()
    records = []
    model, state, _ = ttrainer.fit(cfg, lambda epoch: iter([batch]), lambda: iter([batch]), steps_per_epoch=2,
                                   log_fn=records.append, device="cpu", dtype=torch.float32)
    return records, state.step


def _dryrun_rank(rank, save_dir):
    records, step = _fit(_dryrun_config(save_dir, 2, 2))
    return {"records": records, "step": step}


def test_dryrun_2x2_fit_and_one_rank_restore(tmp_path):
    got = _spawn(tmp_path, 4, _dryrun_rank, tmp_path / "mesh")
    train = got[0]["records"][0]
    assert train["split"] == "train" and np.isfinite(train["loss"]) and train["skipped"] == 0.0
    assert all(r["step"] == 1 for r in got)
    assert all(not r["records"] for r in got[1:])  # only the first rank logs
    ckpt = tmp_path / "mesh" / "best_model.npz"

    want_records, _ = _fit(_dryrun_config(tmp_path / "one", 1, 1))
    assert [r["split"] for r in want_records] == [r["split"] for r in got[0]["records"]] == ["train", "val"]
    for got_r, want_r in zip(got[0]["records"], want_records):
        for k, v in want_r.items():
            if k != "split":
                np.testing.assert_allclose(got_r[k], v, rtol=RTOL, atol=RTOL * 1e-2, err_msg=f"{want_r['split']} {k}")

    cfg = _dryrun_config(tmp_path / "restore", 1, 1)
    model, state = ttrainer.create_train_state(cfg, 2, dtype=torch.float32)
    state, meta = ttrainer.restore_checkpoint(ckpt, model, state)
    assert state.step == 1 and meta["epoch"] == 1 and not meta["params_only"]
    with np.load(ckpt) as z:
        restored = {k: z[k] for k in z.files}
    with np.load(tmp_path / "one" / "best_model.npz") as z:
        one = {k: z[k] for k in z.files}
    lr = float(ttrainer.build_optimizer(cfg, 2).schedule(0))
    _close_states(restored, one, lr, "2 x 2 against one rank")
    np.testing.assert_array_equal(ttrainer.checkpoint_tree(model, state)["params/backbone/block0/mlp/fc1/kernel"],
                                  restored["params/backbone/block0/mlp/fc1/kernel"])
