"""Convert the JAX package's state into the port's tensors and back.

Takes the JAX package's NamedTuples (or anything with the same field
names) holding numpy-convertible arrays, so this module imports neither
JAX nor the JAX package. Packed uint32 descriptor words become int64.

Model weights: ``frontend_state_dict`` and ``segmenter_state_dict`` turn
flax variable trees (nested dicts of numpy arrays, or an ``.npz`` keyed
by the flattened flax path, e.g. ``params/backbone/block0/attn/qkv/kernel``)
into ``state_dict``s of ``models.frontend.LearnedFrontend`` and
``models.segmenter.SemanticSegmenter``. Layouts: dense kernels (in, out)
-> (out, in); conv kernels HWIO -> OIHW; the selector's
``conv1_kernel`` stays (3, 3, C, hid); norm ``scale`` -> ``weight``;
BatchNorm ``batch_stats`` mean / var -> ``running_mean`` / ``running_var``.
``frontend_tree`` / ``segmenter_tree`` go back (a port ``state_dict`` ->
flax-path arrays in flax's layout).

Training state: ``train_state_tree`` flattens the JAX trainer's
``TrainState`` (the optax ``chain(clip, adamw)`` state inside it) into
the keys the port's trainer checkpoints under: ``params/...``,
``batch_stats/...``, ``opt_state/mu/...`` and ``opt_state/nu/...`` (flax
paths, flax layout), ``opt_state/adam_count``,
``opt_state/schedule_count``, ``step`` and ``rng`` (JAX's key words,
carried unchanged); ``jax_train_state_fields`` rebuilds the JAX fields
from such a file on a template state. Loading weights ignores the
optimiser keys, so ``run-slam --checkpoint`` reads a trainer checkpoint.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from .core.camera import PinholeCamera
from .slam.system import MapState
from .slam.tracking import FrameFeatures


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def frame_features(feats, device="cpu") -> FrameFeatures:
    """JAX ``FrameFeatures`` -> the port's, on ``device``."""
    return FrameFeatures(*[_tensor(getattr(feats, f), device) for f in FrameFeatures._fields])


def frame_features_to_numpy(feats: FrameFeatures) -> dict:
    """The port's ``FrameFeatures`` -> numpy arrays by field, packed words
    as uint32 (``tracking.FrameFeatures(**out)`` in the JAX package)."""
    out = {f: getattr(feats, f).detach().cpu().numpy() for f in FrameFeatures._fields}
    out["desc"] = out["desc"].astype(np.uint32)
    return out


def map_state(state, device="cpu") -> MapState:
    """JAX ``MapState`` -> the port's, on ``device`` (ring pointers as ints)."""
    fields = {}
    for f in MapState._fields:
        v = getattr(state, f)
        fields[f] = int(np.asarray(v)) if f in ("write_ptr", "kf_ptr") else _tensor(v, device)
    return MapState(**fields)


def camera(cam) -> PinholeCamera:
    """JAX ``PinholeCamera`` -> the port's."""
    return PinholeCamera(*[getattr(cam, f) for f in PinholeCamera._fields])


def test_pattern(pattern) -> np.ndarray:
    """A (256, 4) BRIEF test pattern as the int8 array ``orb.set_test_pattern`` takes."""
    p = np.asarray(pattern, dtype=np.int8)
    if p.shape != (256, 4):
        raise ValueError(f"test pattern must be (256, 4), got {p.shape}")
    return p


# flax module name -> the port's attribute path, per model.
_FRONTEND_RENAMES = (
    (r"^block(\d+)$", r"blocks.\1"),
    (r"^res(\d+)$", r"res.\1"),
    (r"^Dense_0$", "ctx"),
    (r"^Conv_(\d)$", lambda m: f"conv{int(m.group(1)) + 1}"),
)
_SEGMENTER_RENAMES = (
    (r"^ConvBlock_(\d+)$", r"blocks.\1"),
    (r"^Conv_0$", "conv"),
    (r"^GroupNorm_0$", "norm"),
)
_LEAF_RENAMES = {"scale": "weight", "kernel": "weight", "mean": "running_mean", "var": "running_var"}


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_tree(source) -> dict:
    """A variable tree from a nested dict or an ``.npz`` path, flattened."""
    if isinstance(source, (str, Path)):
        with np.load(source) as z:
            return {k: z[k] for k in z.files}
    return flatten_tree(source)


def save_npz(path, tree) -> None:
    """Write a nested variable tree as an ``.npz`` keyed by flax path."""
    np.savez(path, **flatten_tree(tree))


# Keys of a trainer checkpoint that are not model weights.
TRAIN_STATE_KEYS = ("opt_state", "step", "rng")


def _convert(flat: dict, renames) -> dict:
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] in TRAIN_STATE_KEYS:
            continue
        if parts[0] in ("params", "batch_stats"):
            parts = parts[1:]
        names = []
        for p in parts[:-1]:
            for pat, rep in renames:
                if re.match(pat, p):
                    p = re.sub(pat, rep, p)
                    break
            names.append(p)
        leaf = parts[-1]
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            a = a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1))
        sd[".".join(names + [_LEAF_RENAMES.get(leaf, leaf)])] = torch.from_numpy(np.array(a, order="C"))
    return sd


def frontend_state_dict(source) -> dict:
    """flax ``LearnedFrontend`` variables (``params`` + ``batch_stats``)
    -> ``state_dict`` of the port's ``LearnedFrontend``."""
    return _convert(load_tree(source), _FRONTEND_RENAMES)


def segmenter_state_dict(source) -> dict:
    """flax ``SemanticSegmenter`` params (bare or under ``params``) ->
    ``state_dict`` of the port's ``SemanticSegmenter``."""
    return _convert(load_tree(source), _SEGMENTER_RENAMES)


def _flax_names(name: str, kind: str) -> tuple:
    """A port parameter or buffer name -> (collection, flax path, leaf)."""
    parts = name.split(".")
    mods, leaf = parts[:-1], parts[-1]
    out = []
    i = 0
    while i < len(mods):
        p = mods[i]
        if i + 1 < len(mods) and mods[i + 1].isdigit():
            prefix = {"frontend": {"blocks": "block", "res": "res"}, "segmenter": {"blocks": "ConvBlock_"}}[kind]
            out.append(prefix[p] + mods[i + 1])
            i += 2
            continue
        if kind == "frontend" and out[-1:] == ["offset_head"]:
            p = "Dense_0" if p == "ctx" else f"Conv_{int(p[4:]) - 1}"
        elif kind == "segmenter":
            p = {"conv": "Conv_0", "norm": "GroupNorm_0"}.get(p, p)
        out.append(p)
        i += 1
    collection = "batch_stats" if leaf in ("running_mean", "running_var") else "params"
    return collection, "/".join(out), leaf


def flax_key(name: str, shape, kind: str = "frontend") -> str:
    """The flax path (``params/...`` or ``batch_stats/...``) of a port name."""
    collection, path, leaf = _flax_names(name, kind)
    leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    if leaf == "weight":
        leaf = "scale" if len(shape) == 1 else "kernel"
    return f"{collection}/{path}/{leaf}"


def to_flax_layout(a: np.ndarray) -> np.ndarray:
    """A port weight (out, in) or OIHW -> flax's (in, out) or HWIO."""
    return a.T if a.ndim == 2 else np.transpose(a, (2, 3, 1, 0))


def _tree(state_dict: dict, kind: str) -> dict:
    flat = {}
    for name, t in state_dict.items():
        key = flax_key(name, tuple(t.shape), kind)
        a = t.detach().float().cpu().numpy()
        flat[key] = np.array(to_flax_layout(a) if key.endswith("/kernel") else a, order="C")
    return flat


def frontend_tree(state_dict: dict) -> dict:
    """``LearnedFrontend.state_dict()`` -> {flax path: f32 array}."""
    return _tree(state_dict, "frontend")


def segmenter_tree(state_dict: dict) -> dict:
    """``SemanticSegmenter.state_dict()`` -> {flax path: f32 array}."""
    return _tree(state_dict, "segmenter")


def train_state_tree(state) -> dict:
    """The JAX trainer's ``TrainState`` (numpy leaves) -> the flat keys of a
    port trainer checkpoint. Its optimiser state is optax's
    ``(clip, (ScaleByAdamState, add_decayed_weights, ScaleByScheduleState))``;
    the two counts must agree."""
    adam, sched = state.opt_state[1][0], state.opt_state[1][2]
    adam_count, schedule_count = int(np.asarray(adam.count)), int(np.asarray(sched.count))
    if adam_count != schedule_count:
        raise ValueError(f"optimiser counts differ: adam {adam_count}, schedule {schedule_count}")
    flat = flatten_tree({
        "params": {**state.trainable, **state.frozen},
        "batch_stats": state.batch_stats,
        "opt_state": {"mu": adam.mu, "nu": adam.nu},
    })
    flat["opt_state/adam_count"] = np.asarray(adam_count, np.int32)
    flat["opt_state/schedule_count"] = np.asarray(schedule_count, np.int32)
    flat["step"] = np.asarray(state.step, np.int32)
    flat["rng"] = np.asarray(state.rng, np.uint32)
    return flat


def unflatten(flat: dict, prefix: str) -> dict:
    """{"prefix/a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def jax_train_state_fields(flat: dict, template) -> dict:
    """Fields for ``dataclasses.replace(template, **fields)`` of a JAX
    ``TrainState`` from a port trainer checkpoint (numpy leaves; the
    template gives the trainable/frozen split and optax's state types)."""
    params = unflatten(flat, "params")
    adam, decay, sched = template.opt_state[1]
    count = np.asarray(flat["opt_state/adam_count"], np.int32)
    if int(count) != int(flat["opt_state/schedule_count"]):
        raise ValueError("optimiser counts differ")
    return {
        "step": np.asarray(flat["step"], np.int32),
        "trainable": {k: params[k] for k in template.trainable},
        "frozen": {k: params[k] for k in template.frozen},
        "batch_stats": unflatten(flat, "batch_stats"),
        "opt_state": (template.opt_state[0], (
            adam._replace(count=count, mu=unflatten(flat, "opt_state/mu"), nu=unflatten(flat, "opt_state/nu")),
            decay, sched._replace(count=np.asarray(flat["opt_state/schedule_count"], np.int32)))),
        "rng": np.asarray(flat["rng"], np.uint32),
    }
