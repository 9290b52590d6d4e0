"""Tensor-parallel parameter shards over the mesh's 'model' axis (port of
``parallel/tp.py``).

Megatron-style specs, assigned by flax path substring as JAX assigns
them: column-parallel ``fc1`` / ``qkv`` (a kernel (in, out) split on its
output axis, its bias with it), row-parallel ``fc2`` / ``proj`` (a kernel
split on its input axis; the bias is added after the sum, so it stays
whole). ``spec_for_path`` gives JAX's ``PartitionSpec`` as a tuple:
``(None, 'model')``, ``('model', None)``, ``('model',)`` or ``()``. The
port names its tensors as PyTorch does and keeps dense weights (out, in),
so a column shard is a block of rows and a row shard a block of columns;
each rank holds the contiguous block at its model coordinate, where GSPMD
lays out the same spec.

The substring match reaches more than the ViT: the refiner's residual
blocks and the uncertainty head have ``fc1`` / ``fc2`` too.
``shard_module`` puts a model on the mesh: each Dense whose weight a spec
shards keeps its block and computes in tensor-parallel form
(``models/layers.py::Dense``), and each BatchNorm takes its training
statistics over the 'data' axis. What moves between ranks follows how the
model uses each layer:

- attention: ``qkv``'s block of outputs is gathered, and every rank
  computes all heads (the contiguous block of the 3 * dim outputs does not
  fall on head boundaries, and 2 heads do not split over 4 ranks); ``proj``
  takes its rank's columns of the attention output;
- the ViT's MLP and the uncertainty head: ``fc1``'s block goes through
  the activation straight into ``fc2``'s rows, and only ``fc2``'s partial
  sums are added;
- the refiner's residual block: ``fc1``'s block is gathered for the
  LayerNorm over the full hidden width that sits between ``fc1`` and
  ``fc2``.

With a 'model' axis of one rank nothing changes: same modules, same work.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import convert
from ..models.layers import BatchNorm, Dense
from . import mesh as mesh_lib

COLUMN_PARALLEL = ("fc1", "qkv")  # kernel (in, out): split out
ROW_PARALLEL = ("fc2", "proj")  # kernel (in, out): split in


def spec_for_path(path: str, ndim: int) -> tuple:
    """The PartitionSpec, as a tuple, of a parameter by its flax path."""
    is_kernel = path.endswith("kernel")
    is_bias = path.endswith("bias")
    if any(f"/{n}/" in path for n in COLUMN_PARALLEL):
        if is_kernel and ndim == 2:
            return (None, "model")
        if is_bias and ndim == 1:
            return ("model",)
    if any(f"/{n}/" in path for n in ROW_PARALLEL):
        if is_kernel and ndim == 2:
            return ("model", None)
        # row-parallel bias is added after the sum -> replicated
    return ()


def flax_path(name: str, shape) -> str:
    """``/params/.../kernel``: the path JAX's ``tp._path_str`` gives a
    port tensor's flax leaf, without its trailing slash."""
    return "/" + convert.flax_key(name, tuple(shape))


def tree_shardings(tree: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Each tensor's spec, by its port name (a ``state_dict`` key)."""
    return {k: spec_for_path(flax_path(k, v.shape), v.ndim) for k, v in tree.items()}


def _axis(spec: tuple) -> int | None:
    """The port's axis that ``spec`` shards: flax's kernel axes are the
    port weight's in reverse."""
    if "model" not in spec:
        return None
    return len(spec) - 1 - spec.index("model")


def sharded_names(tree: Dict[str, torch.Tensor]) -> frozenset:
    return frozenset(k for k, s in tree_shardings(tree).items() if s)


def shard_tree(tree: Dict[str, torch.Tensor], mesh: mesh_lib.Mesh) -> Dict[str, torch.Tensor]:
    """Each tensor's block at this rank's model coordinate (whole where its
    spec replicates it)."""
    out = {}
    for k, spec in tree_shardings(tree).items():
        axis = _axis(spec)
        t = tree[k]
        if axis is not None and mesh.num_model > 1:
            if t.shape[axis] % mesh.num_model:
                raise ValueError(f"{k}: axis {axis} of {tuple(t.shape)} does not split over {mesh.num_model} ranks")
            n = t.shape[axis] // mesh.num_model
            t = t.narrow(axis, mesh.model_rank * n, n).clone()
        out[k] = t
    return out


def unshard_tree(tree: Dict[str, torch.Tensor], mesh: mesh_lib.Mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a sharded tree (every rank of the 'model' axis
    takes part). Specs are read from the full shapes, which share the
    shards' number of axes."""
    out = {}
    for k, spec in tree_shardings(tree).items():
        axis = _axis(spec)
        t = tree[k].detach()
        out[k] = mesh_lib.gather(t, mesh.model_group, axis) if axis is not None else t
    return out


def shard_module(model: torch.nn.Module, mesh: mesh_lib.Mesh) -> torch.nn.Module:
    """Put ``model`` on ``mesh`` in place: the sharded Dense layers keep
    their blocks and their tensor-parallel role, the BatchNorms their
    'data' group. The model's parameter objects stay the same (an
    optimiser state or a dict of them still holds them)."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.data_group = mesh.data_group
        if not isinstance(mod, Dense) or mesh.model_group is None:
            continue
        prefix = f"{name}." if name else ""
        spec = spec_for_path(flax_path(prefix + "weight", mod.weight.shape), 2)
        if not spec:
            continue
        params = {prefix + k: p for k, p in (("weight", mod.weight), ("bias", mod.bias)) if p is not None}
        with torch.no_grad():
            for k, block in shard_tree({k: p.detach() for k, p in params.items()}, mesh).items():
                params[k].data = block
        mod.tp_role = "column" if spec == (None, "model") else "row"
        mod.tp_group = mesh.model_group
    return model
