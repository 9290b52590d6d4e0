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
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return torch.sigmoid(self.fc3(x))


def _masked_mean(x: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Mean of ``x`` over ``valid``, the mask applied as a select (XLA's
    compiled form of JAX's ``sum(x * valid) / max(sum(valid), 1)``)."""
    if valid is None:
        return torch.mean(x)
    return torch.sum(torch.where(valid, x, 0.0)) / torch.clamp(torch.sum(valid.to(x.dtype)), min=1.0)


def calibration_loss(confidence: torch.Tensor, actual_error: torch.Tensor, valid: torch.Tensor | None = None,
                     epsilon: float = 1e-6) -> torch.Tensor:
    """MSE between confidence (..., 1) and 1 - error / (max error + eps);
    ``amax`` splits a tied maximum's gradient as ``jnp.max`` does."""
    target = 1.0 - actual_error / (torch.amax(actual_error) + epsilon)
    return _masked_mean((confidence[..., 0] - target) ** 2, valid)


def expected_error_loss(confidence: torch.Tensor, actual_error: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """L1 between the implied error 1 / (conf + 1e-6) - 1 and the measured one."""
    pred_err = 1.0 / (confidence[..., 0] + 1e-6) - 1.0
    return _masked_mean(torch.abs(pred_err - actual_error), valid)


def confidence_mask(confidence: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """(B, N, 1) confidences -> (B, N) bool: at or above ``threshold``, and
    always the most confident keypoint of each image (the first on a tie)."""
    conf = confidence[..., 0]
    best = torch.argmax(conf, dim=-1)
    keep_best = torch.arange(conf.shape[-1], device=conf.device)[None, :] == best[..., None]
    return (conf >= threshold) | keep_best
