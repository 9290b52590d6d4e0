# Frozen copy of semantic_slam_master_tpu_torch/models/refiner.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Descriptor refiner (port of ``models/refiner.py``): backbone features
at keypoints -> L2-normalised descriptors. Input projection + ReLU,
(num_layers - 2) residual blocks, output projection, and the L2
normalisation only at the end; f32 throughout."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dense, LayerNorm, default_generator


class ResidualBlock(nn.Module):
    """[LayerNorm -> Dense -> ReLU -> LayerNorm -> Dense] + identity -> ReLU."""

    def __init__(self, dim: int, gen: torch.Generator):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.fc1 = Dense(dim, dim, gen, init="orthogonal", dtype=torch.float32)
        self.norm2 = LayerNorm(dim)
        self.fc2 = Dense(dim, dim, gen, init="orthogonal", dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.fc1(self.norm1(x)))
        return torch.relu(self.fc2(self.norm2(y)) + x)


class DescriptorRefiner(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 384, output_dim: int = 128, num_layers: int = 4,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.input_proj = Dense(in_dim, hidden_dim, gen, init="orthogonal", dtype=torch.float32)
        self.res = nn.ModuleList(ResidualBlock(hidden_dim, gen) for _ in range(num_layers - 2))
        self.output_proj = Dense(hidden_dim, output_dim, gen, init="orthogonal", dtype=torch.float32)
        if device is not None:
            self.to(device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """(..., C) features -> (..., output_dim) unit descriptors."""
        x = torch.relu(self.input_proj(features))
        for block in self.res:
            x = block(x)
        x = self.output_proj(x)
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp(norm, min=1e-8)
