# Frozen copy of the weight loading of semantic_slam_master_tpu_torch/convert.py
# (the port as of the benchmark's first version), rewritten to import nothing
# of the port: the reference reads the committed .npz files itself.
"""flax variable trees in ``.npz`` files (keyed by flattened flax path) ->
``state_dict``s of the reference's ``LearnedFrontend`` and
``SemanticSegmenter``."""

from __future__ import annotations

import re

import numpy as np
import torch


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


def load_tree(source) -> dict:
    """The flattened variable tree of an ``.npz`` path."""
    with np.load(source) as z:
        return {k: z[k] for k in z.files}



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
