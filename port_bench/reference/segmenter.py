# Frozen copy of semantic_slam_master_tpu_torch/models/segmenter.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""Per-frame semantic segmentation CNN and semantic residual weighting
(port of ``models/segmenter.py``).

Three stride-2 stages, a dilated bottleneck, a skip connection and
logits at 1/4 resolution (``full_res=False``, the SLAM path) or
bilinearly upsampled to the frame. Convs run in ``dtype`` (bf16 by
default) with XLA's ``SAME`` padding (stride 2 on an even size pads
(0, 1); a dilated 3x3 pads the dilation on each side); GroupNorm(8) and
the classifier in f32. The module takes and returns channels-last
tensors, as the JAX module does.

Classes: 0 floor, 1 wall, 2 ceiling, 3 furniture, 4 person/dynamic,
5 other; dynamic classes get near-zero BA weight.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .image import resize_bilinear_nhwc
from .layers import Conv, GroupNorm, default_generator

NUM_CLASSES = 6
CLASS_NAMES = ("floor", "wall", "ceiling", "furniture", "person", "other")
DEFAULT_CLASS_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 0.05, 0.7)


class ConvBlock(nn.Module):
    """3x3 conv (no bias) -> GroupNorm(8) in f32 -> ReLU, over NCHW."""

    def __init__(self, n_in: int, n_out: int, gen: torch.Generator, strides: int = 1, dilation: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv(n_in, n_out, 3, gen, stride=strides, dilation=dilation, bias=False, dtype=dtype)
        self.norm = GroupNorm(8, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.conv(x)))


class SemanticSegmenter(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES, width: int = 32, dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        w = width
        self.blocks = nn.ModuleList([
            ConvBlock(3, w, gen, strides=2, dtype=dtype),  # /2
            ConvBlock(w, 2 * w, gen, strides=2, dtype=dtype),  # /4
            ConvBlock(2 * w, 4 * w, gen, strides=2, dtype=dtype),  # /8
            ConvBlock(4 * w, 4 * w, gen, dilation=2, dtype=dtype),
            ConvBlock(4 * w, 4 * w, gen, dilation=4, dtype=dtype),
            ConvBlock(6 * w, 2 * w, gen, dtype=dtype),  # decoder at /4
        ])
        self.classifier = Conv(2 * w, num_classes, 1, gen, dtype=torch.float32)
        if device is not None:
            self.to(device)

    def forward(self, rgb: torch.Tensor, full_res: bool = True) -> torch.Tensor:
        """rgb (B, H, W, 3) in [0, 1] -> logits (B, H, W, C), or the native
        1/4-resolution logits (B, H/4, W/4, C) with ``full_res=False``."""
        B, H, W, _ = rgb.shape
        b = self.blocks
        x1 = b[0](rgb.permute(0, 3, 1, 2))
        x2 = b[1](x1)
        x3 = b[4](b[3](b[2](x2)))
        x3u = resize_bilinear_nhwc(x3.permute(0, 2, 3, 1), x2.shape[2], x2.shape[3]).permute(0, 3, 1, 2)
        y = b[5](torch.cat([x3u, x2], dim=1))
        logits4 = self.classifier(y).permute(0, 2, 3, 1)
        if not full_res:
            return logits4
        return resize_bilinear_nhwc(logits4, H, W)


def predict_classes(logits: torch.Tensor) -> torch.Tensor:
    """Class per pixel; ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1)


def class_weights_map(labels: torch.Tensor, class_weights: Sequence[float] = DEFAULT_CLASS_WEIGHTS) -> torch.Tensor:
    """Per-pixel BA residual weight from an integer label map (B, H, W)."""
    table = torch.tensor(class_weights, dtype=torch.float32, device=labels.device)
    return table[labels]


def map_coords(xy: torch.Tensor, image_size: tuple, map_size: tuple) -> torch.Tensor:
    """Pixel-centre-aligned rescale of full-resolution (x, y) onto a
    (Hm, Wm) map: (xy + 0.5) * (Wm / W, Hm / H) - 0.5."""
    (H, W), (Hm, Wm) = image_size, map_size
    scale = torch.tensor([Wm / W, Hm / H], dtype=xy.dtype, device=xy.device)
    return (xy + 0.5) * scale - 0.5


