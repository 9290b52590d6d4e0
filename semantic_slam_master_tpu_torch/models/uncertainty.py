"""Per-keypoint confidence head (port of ``models/uncertainty.py``'s
``UncertaintyEstimator``; its training losses are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dense, default_generator


class UncertaintyEstimator(nn.Module):
    """MLP over concat(backbone feature, descriptor) -> sigmoid confidence."""

    def __init__(self, in_dim: int, hidden_dim: int = 128, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.fc1 = Dense(in_dim, hidden_dim, gen, dtype=torch.float32)
        self.fc2 = Dense(hidden_dim, hidden_dim // 2, gen, dtype=torch.float32)
        self.fc3 = Dense(hidden_dim // 2, 1, gen, dtype=torch.float32)
        if device is not None:
            self.to(device)

    def forward(self, backbone_features: torch.Tensor, descriptors: torch.Tensor) -> torch.Tensor:
        """(..., C_feat), (..., C_desc) -> confidence (..., 1) in [0, 1]."""
        x = torch.cat([backbone_features, descriptors], dim=-1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return torch.sigmoid(self.fc3(x))
