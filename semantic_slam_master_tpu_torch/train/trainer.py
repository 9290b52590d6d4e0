"""Training loop for the learned frontend (port of ``train/trainer.py``).

A train step runs the frame pair through the model as the JAX
``_forward_pair`` does -- two separate backbone calls in
BatchNorm training mode (the second starts from the running statistics
the first moved; the step keeps the second's), fixed-K keypoints,
sub-patch offsets, descriptors at the offsets under stop-gradient,
mutual-NN or GT-warp pairs, the weighted loss bundle, the uncertainty
head's calibration terms and the warp-consistency localisation term --
then takes the gradient of the trainable parameters, and steps the
optimiser of ``train.optim`` unless the loss or any gradient is not
finite. A skipped step keeps the parameters, the optimiser state and the
BatchNorm statistics; only ``step`` moves. The eval step runs the same
forward, also in training mode, and drops the statistics.

Trainable are the selector, refiner, estimator and offset head, and the
backbone with ``training.train_backbone``; a frozen backbone gets no
gradient, no share of the clip norm and no decay, but its BatchNorm
statistics still move.

Over a ``('data', 'model')`` mesh (``training.mesh_data`` /
``mesh_model``, ``parallel/mesh.py``) the step is the JAX step of the
global batch. Each rank runs its slice of the batch through the per-image
half of the forward (the backbone's BatchNorm takes its statistics over
the global batch) and its model shards (``parallel/tp.py``); every tensor
the loss reads is then gathered over the 'data' axis, and each rank
computes the whole loss -- the cross-image hard negatives, the descriptor
variance and decorrelation statistics and the per-image means couple the
batch, so a loss per rank with averaged gradients would be another step.
The gradients are summed over 'data', the replicated ones broadcast over
'model', the clip norm is that of the full tensors, and one finite check
decides for every rank.

Checkpoints are ``.npz`` files keyed by the flax tree's paths
(``convert.py``): ``params``, ``batch_stats``, the optimiser's moments
and counts, ``step`` and ``rng`` (JAX's key words, carried unchanged),
with ``<name>.meta.json`` beside them (``epoch``, ``val_loss``,
``params_only``), as the JAX trainer writes beside its orbax directory.
They always hold the full arrays, written by the first rank, so a
checkpoint of one mesh shape restores on any other.

On the card, ``torch.gather``'s backward (bilinear feature sampling,
``take_along_axis``) adds with atomics, so two runs agree within rounding,
not bit for bit; on the CPU a resumed run equals an uninterrupted one.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..core import prng
from ..core.device import resolve_device
from ..losses import self_supervised as losses
from ..models import uncertainty
from ..models.backbone import patch_to_pixel
from ..models.frontend import LearnedFrontend
from ..models.selector import select_keypoints
from ..ops import matching
from ..parallel import mesh as mesh_lib, tp
from .config import Config, build_model
from .optim import AdamW, AdamWState, warmup_cosine_decay_schedule

TRAINABLE = ("selector", "refiner", "estimator", "offset_head")
TRAINABLE_WITH_BACKBONE = TRAINABLE + ("backbone",)


@dataclass
class TrainState:
    """The model's tensors by name (the trainable ones, the frozen ones and
    the BatchNorm statistics are the model's own), the optimiser state,
    the step and JAX's PRNG key words."""

    step: int
    trainable: Dict[str, torch.Tensor]
    frozen: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamWState
    rng: np.ndarray


def split_params(params: Dict[str, torch.Tensor], keys: Tuple[str, ...] = TRAINABLE):
    """(trainable, frozen) by top-level module name."""
    trainable = {k: v for k, v in params.items() if k.split(".")[0] in keys}
    frozen = {k: v for k, v in params.items() if k.split(".")[0] not in keys}
    return trainable, frozen


def flax_order(names) -> list:
    """Parameter names in the leaf order of the flax tree (sorted paths)."""
    return sorted(names, key=lambda n: tuple(convert.flax_key(n, (0, 0)).split("/")))


def build_optimizer(cfg: Config, steps_per_epoch: int, order=(), mesh: mesh_lib.Mesh | None = None,
                    sharded: frozenset = frozenset()) -> AdamW:
    """``clip_by_global_norm(grad_clip)`` then AdamW on a warm-up + cosine
    schedule, with the JAX trainer's clamps for short runs; ``mesh`` and
    ``sharded`` as ``AdamW`` takes them."""
    t = cfg.training
    total_steps = max(t.epochs * steps_per_epoch, 2)
    warmup = min(t.warmup_epochs * steps_per_epoch, total_steps - 1)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0 if warmup > 0 else t.lr, peak_value=t.lr, warmup_steps=max(warmup, 1),
        decay_steps=total_steps, end_value=t.lr_min,
    )
    return AdamW(schedule, t.weight_decay, t.grad_clip, list(order), mesh, sharded)


def create_train_state(cfg: Config, steps_per_epoch: int, device="cpu", dtype=torch.bfloat16,
                       generator: torch.Generator | None = None) -> Tuple[LearnedFrontend, TrainState]:
    """The model (weights drawn from ``training.seed``) and a fresh state;
    ``rng`` is the key the JAX trainer keeps, split from PRNGKey(seed)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(cfg.training.seed)
    model = build_model(cfg.model, dtype=dtype, generator=gen).to(device)
    keys = TRAINABLE_WITH_BACKBONE if cfg.training.train_backbone else TRAINABLE
    trainable, frozen = split_params(dict(model.named_parameters()), keys)
    for p in trainable.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    tx = build_optimizer(cfg, steps_per_epoch, flax_order(trainable))
    return model, TrainState(
        step=0, trainable=trainable, frozen=frozen, batch_stats=dict(model.named_buffers()),
        opt_state=tx.init(trainable), rng=prng.split(prng.PRNGKey(cfg.training.seed))[0],
    )


def _forward_pair(model: LearnedFrontend, rgb1, rgb2, cfg: Config, extras=None,
                  mesh: mesh_lib.Mesh | None = None):
    """(LossBundle, metrics) of a frame pair; ``extras`` (depth1, K, K2,
    rel_pose) turns on GT-warp pairs and the localisation term. On a mesh
    the inputs are this rank's slice, and the loss is of the global batch."""
    terms = _pair_terms(model, rgb1, rgb2, cfg, extras)
    if mesh is not None:
        terms = {k: mesh_lib.gather(v, mesh.data_group) for k, v in terms.items()}
    return _pair_loss(terms, cfg)


def _pair_terms(model: LearnedFrontend, rgb1, rgb2, cfg: Config, extras=None) -> Dict[str, torch.Tensor]:
    """The per-image half of the forward: every tensor the loss reads, each
    with the batch axis first."""
    feats1, sal1 = model.features_and_saliency(rgb1, train=True)
    feats2, sal2 = model.features_and_saliency(rgb2, train=True)
    num_kp = cfg.model.num_keypoints
    kp1 = select_keypoints(sal1.detach(), num_kp)
    kp2 = select_keypoints(sal2.detach(), num_kp)
    xy1, xy2 = kp1.xy, kp2.xy
    if cfg.model.subpatch_refine:
        xy1 = model.refine_at(feats1, sal1, rgb1, kp1.xy)
        xy2 = model.refine_at(feats2, sal2, rgb2, kp2.xy)
    _, desc1, conf1 = model.describe_at(feats1, xy1.detach())
    _, desc2, _ = model.describe_at(feats2, xy2.detach())

    m = matching.match_cosine(desc1, desc2, kp1.valid, kp2.valid, ratio=None)
    ps = model.patch_size
    lc = cfg.loss
    neg_ok = None
    if lc.gt_supervision and extras is not None:
        gt = losses.gt_match_pairs(
            patch_to_pixel(xy1.detach(), ps), patch_to_pixel(xy2.detach(), ps), kp1.valid, kp2.valid,
            extras["depth1"], extras["K"], extras["rel_pose"], K2=extras.get("K2"),
            radius=lc.gt_match_radius, safe_radius=lc.safe_radius if lc.hard_negatives else None,
        )
        pairs, pair_valid = gt[0], gt[1]
        neg_ok = gt[2] if lc.hard_negatives else None
        loc_idx2, loc_valid = pairs[..., 1], pair_valid
    else:
        pairs, pair_valid = matching.matches_to_pairs(m, num_kp)
        loc_idx2, loc_valid = m.idx2, m.valid & kp1.valid

    terms = {"desc1": desc1, "desc2": desc2, "pairs": pairs, "pair_valid": pair_valid, "sal1": sal1, "sal2": sal2,
             "rgb1": rgb1, "conf1": conf1, "score": m.score, "conf_valid": m.valid & kp1.valid, "count": m.count()}
    if neg_ok is not None:
        terms.update(neg_ok=neg_ok, valid2=kp2.valid)
    if lc.weights.get("localization", 0.0) and cfg.model.subpatch_refine and extras is not None:
        uv2 = patch_to_pixel(xy2, ps)
        terms.update(uv1=patch_to_pixel(xy1, ps), loc_valid=loc_valid, depth1=extras["depth1"], K=extras["K"],
                     uv2_matched=torch.gather(uv2, 1, loc_idx2[..., None].expand(*loc_idx2.shape, 2)),
                     rel_pose=extras["rel_pose"])
        if extras.get("K2") is not None:
            terms["K2"] = extras["K2"]
    return terms


def _pair_loss(t: Dict[str, torch.Tensor], cfg: Config):
    """(LossBundle, metrics) of the terms of :func:`_pair_terms`."""
    lc = cfg.loss
    bundle = losses.total_loss(
        t["desc1"], t["desc2"], t["pairs"], t["pair_valid"], t["sal1"], t["sal2"], t["rgb1"], weights=lc.weights,
        temperature=lc.desc_temperature, target_variance=lc.target_variance, target_mean=lc.sparsity_target,
        sparsity_penalty=lc.sparsity_penalty, neg_ok=t.get("neg_ok"), valid2=t.get("valid2"),
        cross_image=lc.cross_image_negatives, hard_margin=lc.hard_margin,
    )

    match_err = losses.clip(1.0 - t["score"], 0.0, 2.0)
    cal = uncertainty.calibration_loss(t["conf1"][..., None], match_err, t["conf_valid"])
    ee = uncertainty.expected_error_loss(t["conf1"][..., None], match_err, t["conf_valid"])
    w = lc.weights
    extra = w.get("calibration", 0.3) * cal + w.get("expected_error", 0.02) * ee
    comps = {**bundle.components, "calibration": cal, "expected_error": ee}

    if "uv1" in t:
        loc = losses.localization_loss(t["uv1"], t["uv2_matched"], t["loc_valid"], t["depth1"], t["K"],
                                       t["rel_pose"], max_residual=12.0, K2=t.get("K2"))
        loc = losses.guard(loc, 0.0)
        extra = extra + w["localization"] * loc
        comps["localization"] = loc

    bundle = losses.LossBundle(total=bundle.total + losses.guard(extra, 0.0), components=comps)
    s1, d1 = t["sal1"].detach(), t["desc1"].detach()
    metrics = {
        "num_matches": torch.mean(t["count"].float()),
        "mean_saliency": torch.mean(s1),
        "max_saliency": torch.amax(s1),
        "saliency_variance": torch.var(s1, correction=0),
        "descriptor_variance": torch.var(d1, correction=0),
    }
    return bundle, metrics


def _extras(batch):
    return batch if "rel_pose" in batch else None


def make_train_step(model: LearnedFrontend, cfg: Config, tx: AdamW, mesh: mesh_lib.Mesh | None = None):
    """``train_step(state, batch) -> (state, outputs)`` on device tensors;
    the state's tensors are updated in place. On ``mesh`` the batch is this
    rank's slice and the model is on the mesh (``tp.shard_module``)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        saved = {k: b.clone() for k, b in state.batch_stats.items()}
        names = list(state.trainable)
        with torch.enable_grad():
            bundle, metrics = _forward_pair(model, batch["rgb1"], batch["rgb2"], cfg, _extras(batch), mesh)
            loss = bundle.total
            grads = torch.autograd.grad(loss, [state.trainable[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(state.trainable[k]) if g is None else g for k, g in zip(names, grads)}
        if mesh is not None:
            grads = mesh_lib.reduce_grads(mesh, grads, [k for k in names if k not in tx.sharded])
        finite = torch.isfinite(loss.detach())
        for g in grads.values():
            finite = finite & torch.isfinite(g).all()
        if mesh is not None:
            finite = torch.full_like(finite, mesh_lib.all_true(mesh, finite))
        new_params, new_opt, _ = tx.update(grads, state.opt_state, state.trainable)
        with torch.no_grad():
            if bool(finite):
                for k, p in state.trainable.items():
                    p.copy_(new_params[k])
                state.opt_state = new_opt
            else:
                for k, b in state.batch_stats.items():
                    b.copy_(saved[k])
        state.step += 1
        out = {"loss": loss.detach(), "skipped": ~finite,
               **{k: v.detach() for k, v in bundle.components.items()}, **metrics}
        return state, out

    return train_step


def make_eval_step(model: LearnedFrontend, cfg: Config, mesh: mesh_lib.Mesh | None = None):
    """``eval_step(state, batch) -> outputs``: the train step's forward
    (BatchNorm in training mode, as the JAX eval step runs it), the moved
    statistics put back."""

    def eval_step(state: TrainState, batch) -> Dict:
        saved = {k: b.clone() for k, b in state.batch_stats.items()}
        with torch.no_grad():
            bundle, metrics = _forward_pair(model, batch["rgb1"], batch["rgb2"], cfg, _extras(batch), mesh)
            for k, b in state.batch_stats.items():
                b.copy_(saved[k])
        return {"loss": bundle.total, **bundle.components, **metrics}

    return eval_step


# ---------------------------------------------------------------------------
# Checkpoints: .npz keyed by flax path, and <name>.meta.json.
# ---------------------------------------------------------------------------


def meta_path(path) -> Path:
    """``<dir>/<name>.meta.json`` beside ``<dir>/<name>.npz``."""
    return Path(path).with_suffix(".meta.json")


def checkpoint_tree(model: LearnedFrontend, state: TrainState, params_only: bool = False,
                    mesh: mesh_lib.Mesh | None = None) -> dict:
    """The flat arrays of a checkpoint (``convert.train_state_tree``'s keys),
    full arrays where ``mesh`` shards them (every rank of it takes part)."""

    def full(tree):
        return tp.unshard_tree(dict(tree), mesh) if mesh is not None and mesh.model_group is not None else tree

    flat = convert.frontend_tree(full(model.state_dict()))
    flat["step"] = np.asarray(state.step, np.int32)
    if params_only:
        return flat
    for moment in ("mu", "nu"):
        for name, t in full(getattr(state.opt_state, moment)).items():
            key = convert.flax_key(name, tuple(t.shape))
            a = t.detach().float().cpu().numpy()
            flat[f"opt_state/{moment}/" + key.split("/", 1)[1]] = np.array(
                convert.to_flax_layout(a) if key.endswith("/kernel") else a, order="C")
    flat["opt_state/adam_count"] = np.asarray(state.opt_state.adam_count, np.int32)
    flat["opt_state/schedule_count"] = np.asarray(state.opt_state.schedule_count, np.int32)
    flat["rng"] = np.asarray(state.rng, np.uint32)
    return flat


def save_checkpoint(path, model: LearnedFrontend, state: TrainState, metadata: Dict | None = None,
                    params_only: bool = False, mesh: mesh_lib.Mesh | None = None) -> Path:
    """Write ``path`` (``.npz``) and its ``.meta.json``; ``params_only``
    drops the optimiser state and the PRNG key. On ``mesh`` every rank
    calls it and the first writes the full arrays."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    flat = checkpoint_tree(model, state, params_only, mesh)
    if mesh is not None and mesh.rank != 0:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    meta = dict(metadata or {})
    meta["params_only"] = params_only
    meta_path(path).write_text(json.dumps(meta))
    return path


def restore_checkpoint(path, model: LearnedFrontend, state: TrainState) -> Tuple[TrainState, Dict]:
    """Load ``path`` into ``model`` and ``state``. A file without optimiser
    state (params only, or bare weights) loads the weights and keeps the
    state's optimiser, step and key, as the JAX trainer's restore does."""
    meta_file = meta_path(path)
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dev = next(model.parameters()).device
    with torch.no_grad():
        model.load_state_dict({k: v.to(dev) for k, v in convert.frontend_state_dict(flat).items()})
    if "opt_state/adam_count" not in flat:
        meta.setdefault("params_only", True)
        return state, meta

    def moments(name):
        sub = {"params/" + k[len(f"opt_state/{name}/"):]: v for k, v in flat.items()
               if k.startswith(f"opt_state/{name}/")}
        sd = convert.frontend_state_dict(sub)
        if set(sd) != set(state.trainable):
            raise ValueError(f"{path}: optimiser {name} holds {sorted(set(sd) ^ set(state.trainable))} "
                             "beyond or short of the trainable parameters")
        return {k: sd[k].to(dev) for k in state.trainable}

    adam_count, schedule_count = int(flat["opt_state/adam_count"]), int(flat["opt_state/schedule_count"])
    if adam_count != schedule_count:
        raise ValueError(f"{path}: optimiser counts differ (adam {adam_count}, schedule {schedule_count})")
    state.opt_state = AdamWState(moments("mu"), moments("nu"), adam_count, schedule_count)
    state.step = int(flat["step"])
    state.rng = np.asarray(flat["rng"], np.uint32)
    return state, meta


# ---------------------------------------------------------------------------
# Fit loop
# ---------------------------------------------------------------------------


def to_mesh(model: LearnedFrontend, state: TrainState, cfg: Config, steps_per_epoch: int,
            mesh: mesh_lib.Mesh) -> AdamW:
    """Put a full model and state on ``mesh`` in place (every rank calls it):
    the first rank's weights, statistics and moments broadcast, then this
    rank's shards kept. Returns the mesh's optimiser."""
    mesh_lib.replicate(mesh, [*model.state_dict().values(), *state.opt_state.mu.values(),
                              *state.opt_state.nu.values()])
    tp.shard_module(model, mesh)
    state.opt_state.mu = tp.shard_tree(state.opt_state.mu, mesh)
    state.opt_state.nu = tp.shard_tree(state.opt_state.nu, mesh)
    return build_optimizer(cfg, steps_per_epoch, flax_order(state.trainable), mesh, tp.sharded_names(state.trainable))


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True) for k, v in batch.items()}


def _floats(out: Dict) -> Dict[str, float]:
    keys = list(out)
    vals = torch.stack([torch.as_tensor(out[k]).detach().to(torch.float64).reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


def fit(
    cfg: Config,
    train_batches: Callable[[int], Iterator[Dict]],
    val_batches: Optional[Callable[[], Iterator[Dict]]] = None,
    steps_per_epoch: int = 16,
    log_fn: Callable[[Dict], None] = lambda m: None,
    init_from=None,
    resume_from=None,
    device="cuda",
    dtype=torch.bfloat16,
    step_times: list | None = None,
):
    """Epoch loop with best-by-val checkpoint retention, as the JAX ``fit``:
    ``train_batches(epoch)`` yields dicts of numpy arrays; ``init_from``
    warm-starts the weights with a fresh optimiser and schedule;
    ``resume_from`` restores the whole state from a full checkpoint and
    picks up at its epoch + 1. ``steps_per_epoch`` sizes the schedule only.
    ``step_times`` (a list) collects each train step's seconds on the
    device's clock. Returns (model, state, history).

    The mesh is ``training.mesh_data`` x ``mesh_model`` over the process
    group (``parallel.mesh.make_mesh``: a mesh of more than one rank
    without a group of that size raises). Every rank reads the same
    batches and keeps its slice; the first rank's state is broadcast, then
    sharded; only the first rank logs and writes checkpoints. The returned
    model and state hold this rank's shards."""
    device = resolve_device(device)
    t = cfg.training
    mesh = mesh_lib.make_mesh(t.mesh_data, t.mesh_model)
    model, state = create_train_state(cfg, steps_per_epoch, device=device, dtype=dtype)
    best_val = float("inf")
    start_epoch = 1
    if resume_from is not None:
        state, meta = restore_checkpoint(resume_from, model, state)
        if meta.get("params_only", False):
            raise ValueError(f"{resume_from} is a params-only checkpoint; true resume needs the optimizer "
                             "state (use init_from to warm-start)")
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_val = float(meta.get("val_loss", float("inf")))
    elif init_from is not None:
        fresh = state.opt_state, state.step, state.rng
        state, _ = restore_checkpoint(init_from, model, state)
        state.opt_state, state.step, state.rng = fresh
    tx = to_mesh(model, state, cfg, steps_per_epoch, mesh)
    train_step = make_train_step(model, cfg, tx, mesh)
    eval_step = make_eval_step(model, cfg, mesh)
    history = {"train": [], "val": []}
    save_dir = Path(t.save_dir)
    cuda = device.type == "cuda"
    first = mesh.rank == 0

    for epoch in range(start_epoch, t.epochs + 1):
        agg: Dict[str, float] = {}
        n = 0
        for batch in train_batches(epoch):
            batch = to_device(mesh_lib.shard_batch(mesh, batch), device)
            if cuda and step_times is not None:
                ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev[0].record()
            state, out = train_step(state, batch)
            if cuda and step_times is not None:
                ev[1].record()
                ev[1].synchronize()
                step_times.append(ev[0].elapsed_time(ev[1]) / 1e3)
            for k, v in _floats(out).items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        train_metrics = {k: v / max(n, 1) for k, v in agg.items()}
        train_metrics["epoch"] = epoch
        history["train"].append(train_metrics)
        if first:
            log_fn({"split": "train", **train_metrics})

        if val_batches is not None and epoch % t.val_interval == 0:
            vagg: Dict[str, float] = {}
            vn = 0
            for batch in val_batches():
                for k, v in _floats(eval_step(state, to_device(mesh_lib.shard_batch(mesh, batch), device))).items():
                    vagg[k] = vagg.get(k, 0.0) + v
                vn += 1
            val_metrics = {k: v / max(vn, 1) for k, v in vagg.items()}
            val_metrics["epoch"] = epoch
            history["val"].append(val_metrics)
            if first:
                log_fn({"split": "val", **val_metrics})
            if val_metrics.get("loss", math.inf) < best_val:
                best_val = val_metrics["loss"]
                save_checkpoint(save_dir / "best_model.npz", model, state,
                                metadata={"epoch": epoch, "val_loss": best_val}, mesh=mesh)
    return model, state, history
