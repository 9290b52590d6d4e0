"""The ``('data', 'model')`` mesh and its collectives (port of
``parallel/mesh.py``).

JAX names a device mesh over one program and XLA inserts every
collective. Here each process is one rank of the mesh, and the
collectives are written out in ``torch.distributed``. Rank r sits at data
coordinate ``r // num_model`` and model coordinate ``r % num_model``, the
order of JAX's reshape of its device list to (num_data, num_model):

- **data**: batches (frame pairs, sequences) are cut along this axis;
- **model**: tensor-parallel shards of the ViT and head matmuls
  (``parallel/tp.py``).

A mesh of one rank needs no process group. A mesh of more ranks needs one
of exactly ``num_data * num_model`` ranks (``torchrun`` and
:func:`init_from_env`, or ``init_process_group``); anything else raises,
so a run never falls back to one device.

The collectives use only ``all_reduce`` and ``broadcast``: the two that
gloo takes on CUDA tensors as well as CPU ones, and NCCL on CUDA ones. So
the same code runs under gloo on CPU processes, under gloo with several
ranks on one card (NCCL refuses two ranks on one GPU), and under NCCL
with a rank per card. Floats travel as float32 (float64 as itself),
integers and booleans as int32 (int64 as itself). A gather is the sum of
zero-filled buffers, each rank's piece in its own slot.

Those on the gradient path carry their autograd rule. Every rank computes
the whole function of a gathered tensor, so its gradient is counted once,
not once per rank:

- ``gather``: pieces concatenated along an axis; backward, each rank takes
  the slice of the gradient that belongs to its piece;
- ``split``: this rank's piece; backward, the pieces' gradients gathered;
- ``copy_to``: the identity; backward, the gradient summed over the group
  (the input of a column-parallel matmul);
- ``reduce_from``: the sum over the group; backward, the identity (the
  partial sums of a row-parallel matmul);
- ``all_reduce``: the sum both ways (a statistic every rank uses, as
  BatchNorm's).

A group of ``None``, an axis of one rank, makes each of them the identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``('data', 'model')`` mesh and the process
    groups of its two axes (``None`` for an axis of one rank)."""

    num_data: int = 1
    num_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None  # the ranks that share this model coordinate
    model_group: Any = None  # the ranks that share this data coordinate

    @property
    def size(self) -> int:
        return self.num_data * self.num_model

    @property
    def rank(self) -> int:
        return self.data_rank * self.num_model + self.model_rank


def init_from_env(device) -> bool:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``): NCCL when
    each local rank has a card of its own, gloo when ranks share one card
    or run on the CPU. Returns whether it started the group (the caller
    destroys it); False for a lone process or a group already up."""
    if int(os.environ.get("WORLD_SIZE", "1")) == 1 or dist.is_initialized():
        return False
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
        if cards >= local_world:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return True


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """This rank's mesh over every rank of the process group; ``num_data``
    defaults to ranks // ``num_model``. Every rank must call it, in the
    same order as its other collectives (it creates the axes' groups)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is None:
        if num_model < 1 or world % num_model:
            raise ValueError(f"a 'model' axis of {num_model} does not divide {world} ranks")
        num_data = world // num_model
    if num_data < 1 or num_model < 1 or num_data * num_model != world:
        if not dist.is_initialized() and num_data * num_model > 1:
            raise ValueError(f"a {num_data}x{num_model} mesh needs {num_data * num_model} ranks and no process "
                             "group is initialised: launch with torchrun")
        raise ValueError(f"mesh {num_data}x{num_model} != {world} ranks")
    if world == 1:
        return Mesh()
    d, m = divmod(dist.get_rank(), num_model)
    data_group = model_group = None
    if num_model > 1:
        for dd in range(num_data):
            g = dist.new_group([dd * num_model + mm for mm in range(num_model)])
            if dd == d:
                model_group = g
    if num_data > 1:
        for mm in range(num_model):
            g = dist.new_group([dd * num_model + mm for dd in range(num_data)])
            if mm == m:
                data_group = g
    return Mesh(num_data, num_model, d, m, data_group, model_group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wire(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point:
        return torch.float64 if dtype == torch.float64 else torch.float32
    return torch.int64 if dtype == torch.int64 else torch.int32


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.detach().to(_wire(x.dtype), copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    buf = torch.zeros(shape, dtype=_wire(x.dtype), device=x.device)
    buf.narrow(dim, rank * n, n).copy_(x.detach())
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _piece(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % size:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split over {size} ranks")
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _piece(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim``, in rank order."""
    if group is None:
        return x
    dim %= x.ndim
    return _Gather.apply(x, group, dim) if x.requires_grad else _gather(x, group, dim)


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous piece of ``x`` along ``dim``."""
    if group is None:
        return x
    dim %= x.ndim
    return _Split.apply(x, group, dim) if x.requires_grad else _piece(x, group, dim)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduce.apply(x, group)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous slice of the leading axis of an array or
    tensor, or of each in a dict, by its data coordinate: the piece JAX's
    ``P('data')`` puts on its device. Raises where the leading axis does
    not divide by the data axis."""

    def piece(x):
        n = len(x)
        if n % mesh.num_data:
            raise ValueError(f"a batch of {n} does not split over a data axis of {mesh.num_data}")
        k = n // mesh.num_data
        return x[mesh.data_rank * k : (mesh.data_rank + 1) * k]

    if mesh.num_data == 1:
        return batch
    return {k: piece(v) for k, v in batch.items()} if isinstance(batch, dict) else piece(batch)


def replicate(mesh: Mesh, tensors):
    """Broadcast each tensor in place from the first rank, so every rank
    holds its values; returns ``tensors``."""
    if mesh.size > 1:
        for t in tensors:
            buf = t.detach().to(_wire(t.dtype), copy=True).contiguous()
            dist.broadcast(buf, src=0)
            with torch.no_grad():
                t.copy_(buf)
    return tensors


def all_true(mesh: Mesh, flag: torch.Tensor) -> bool:
    """Whether ``flag`` (a boolean tensor) holds on every rank: one decision
    for the whole mesh."""
    if mesh.size == 1:
        return bool(flag)
    bad = (~flag.reshape(())).to(torch.int32).reshape(1)
    dist.all_reduce(bad)
    return int(bad) == 0


def _flat_apply(tensors: Dict[str, torch.Tensor], op) -> Dict[str, torch.Tensor]:
    """``op`` on one flat buffer of the tensors (float32 on the wire), the
    results cut back to their shapes and dtypes."""
    if not tensors:
        return {}
    buf = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors.values()])
    op(buf)
    sizes = [t.numel() for t in tensors.values()]
    return {k: piece.reshape(t.shape).to(t.dtype)
            for (k, t), piece in zip(tensors.items(), torch.split(buf, sizes))}


def reduce_grads(mesh: Mesh, grads: Dict[str, torch.Tensor], replicated) -> Dict[str, torch.Tensor]:
    """Gradients of the mesh's step: every leaf summed over the data axis
    (each rank holds its slice of the batch's contribution), then the
    replicated leaves (names in ``replicated``) broadcast from model
    coordinate 0, so every rank holds the same values of each."""
    out = dict(grads)
    if mesh.data_group is not None:
        out = _flat_apply(out, lambda b: dist.all_reduce(b, group=mesh.data_group))
    if mesh.model_group is not None:
        src = mesh.data_rank * mesh.num_model
        replicated = set(replicated)
        out.update(_flat_apply({k: out[k] for k in out if k in replicated},
                               lambda b: dist.broadcast(b, src=src, group=mesh.model_group)))
    return out
