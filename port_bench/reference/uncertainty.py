# Frozen copy of semantic_slam_master_tpu_torch/models/uncertainty.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Per-keypoint confidence head and its training losses (port of
``models/uncertainty.py``): calibration MSE against 1 - normalised error
and the L1 of the implied error 1/conf - 1, both mask-aware."""

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
        x = torch.relu(self.fc1(x, sharded=True))
        x = torch.relu(self.fc2(x, sharded=True))
        return torch.sigmoid(self.fc3(x))


