"""Layers with flax's arithmetic, shared by the port's models.

Each layer keeps its parameters in PyTorch's layout (dense weights
(out, in), conv weights OIHW, norm ``weight``/``bias``) and computes as
the flax layer it replaces does:

- ``Dense`` / ``Conv`` cast input, weight and bias to the layer's
  ``dtype`` (flax's ``promote_dtype``), then multiply and add the bias
  as two operations;
- ``LayerNorm`` / ``GroupNorm`` take the mean and E[x^2] - mean^2 in
  f32 (flax's fast variance, clipped at 0), eps 1e-6, and apply
  ``(x - mean) * (rsqrt(var + eps) * weight) + bias``; ``BatchNorm``
  does the same with its running statistics, eps 1e-5, or in training
  mode with the batch's (the same fast variance, biased), and then moves
  the running statistics by flax's rule, ``ra <- 0.9 ra + 0.1 batch``
  (not ``F.batch_norm``'s: that one updates with the unbiased variance).

On a mesh (``parallel/tp.py::shard_module``) a ``Dense`` can hold a
tensor-parallel block of its weight: a column-parallel one its block of
outputs (its input's gradient summed over the 'model' ranks), a
row-parallel one its block of inputs (its partial products summed, then
the whole bias added); and a ``BatchNorm`` in training mode takes its
statistics over the global batch, the sums of x and x^2 added over the
'data' ranks.

Parameters are drawn on the CPU from an explicit ``torch.Generator``, so
a seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as mesh_lib


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Near flax's default kernel init (variance 1/fan_in, truncated at 2
    sigma): a normal clipped at 2 sigma."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.clamp(torch.randn(shape, generator=gen) * std, -2 * std, 2 * std)


def xavier_uniform(shape, fan_in: int, fan_out: int, gen: torch.Generator) -> torch.Tensor:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim


def orthogonal(n_in: int, n_out: int, gen: torch.Generator) -> torch.Tensor:
    """(n_out, n_in) weight with orthonormal rows or columns."""
    a = torch.randn((max(n_in, n_out), min(n_in, n_out)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if n_out >= n_in else q.T


def normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), bias (out,)."""

    def __init__(self, n_in: int, n_out: int, gen: torch.Generator, init: str = "lecun", dtype=None):
        super().__init__()
        if init == "lecun":
            w = lecun_normal((n_in, n_out), n_in, gen).T
        elif init == "xavier":
            w = xavier_uniform((n_out, n_in), n_in, n_out, gen)
        elif init == "orthogonal":
            w = orthogonal(n_in, n_out, gen)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.weight = nn.Parameter(w.contiguous())
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.dtype = dtype
        self.tp_role = None  # "column" | "row" on a 'model' axis (parallel/tp.py)
        self.tp_group = None

    def forward(self, x: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        """``sharded``: a column-parallel layer returns this rank's block of
        its outputs, a row-parallel one takes this rank's block of its
        inputs; by default both take and return whole tensors."""
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if self.tp_role == "row":
            if not sharded:
                x = mesh_lib.split(x, self.tp_group, -1)
            y = mesh_lib.reduce_from(torch.matmul(x.to(dt), self.weight.to(dt).T), self.tp_group)
            return y + self.bias.to(dt)
        if self.tp_role == "column":
            x = mesh_lib.copy_to(x, self.tp_group)
        y = torch.matmul(x.to(dt), self.weight.to(dt).T)
        y = y + self.bias.to(dt)
        if self.tp_role == "column" and not sharded:
            y = mesh_lib.gather(y, self.tp_group, -1)
        return y


def same_padding(size: int, kernel: int, stride: int, dilation: int):
    """(low, high) padding of XLA's ``SAME`` for one spatial axis."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``SAME`` padding over NCHW tensors: weight
    OIHW, optional bias."""

    def __init__(self, n_in: int, n_out: int, kernel: int, gen: torch.Generator, stride: int = 1,
                 dilation: int = 1, bias: bool = True, init: str = "lecun", dtype=None):
        super().__init__()
        fan_in = n_in * kernel * kernel
        if init == "zeros":
            w = torch.zeros((n_out, n_in, kernel, kernel))
        else:
            w = lecun_normal((kernel, kernel, n_in, n_out), fan_in, gen).permute(3, 2, 0, 1)
        self.weight = nn.Parameter(w.contiguous())
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None
        self.kernel, self.stride, self.dilation, self.dtype = kernel, stride, dilation, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        ph = same_padding(x.shape[2], self.kernel, self.stride, self.dilation)
        pw = same_padding(x.shape[3], self.kernel, self.stride, self.dilation)
        x = F.pad(x.to(dt), (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x, self.weight.to(dt), stride=self.stride, dilation=self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y


def normalize(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * weight) + bias."""
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def fast_stats(x: torch.Tensor, dims):
    """Mean and E[x^2] - mean^2 (clipped at 0) in f32 over ``dims``."""
    x = x.float()
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return x, mean, var


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=f32)`` over the last axis; f32 out."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, mean, var = fast_stats(x, (-1,))
        return normalize(x, mean, var, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=f32)`` over NCHW; f32 out."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        g = x.reshape(B, self.groups, C // self.groups, H, W)
        g, mean, var = fast_stats(g, (2, 3, 4))
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, self.groups, -1, 1, 1)
        y = (g - mean) * mul + self.bias.reshape(1, self.groups, -1, 1, 1)
        return y.reshape(B, C, H, W)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the last axis of (N, C):
    ``use_running_average=not train``."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps, self.momentum = eps, momentum
        self.data_group = None  # the 'data' ranks whose batches make the global one

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return normalize(x.float(), self.running_mean, self.running_var, self.weight, self.bias, self.eps)
        if self.data_group is None:
            x, mean, var = fast_stats(x, (0,))
            mean, var = mean[0], var[0]
        else:
            x = x.float()
            n = x.shape[0] * mesh_lib.group_size(self.data_group)
            sums = mesh_lib.all_reduce(torch.stack([x.sum(0), (x * x).sum(0)]), self.data_group) / n
            mean = sums[0]
            var = torch.clamp(sums[1] - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return normalize(x, mean, var, self.weight, self.bias, self.eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
