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
    """A (256, 4) BRIEF test pattern as the int8 array ``orb.describe`` takes."""
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


def _convert(flat: dict, renames) -> dict:
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
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
