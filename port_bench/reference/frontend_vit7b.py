# The plain reference of the learned frontend on DINOv3 ViT-7B/16, written
# from the architecture's equations (Simeoni et al., DINOv3, arXiv:2508.10104,
# Table 1; the `dinov3` repository's `vit_7b`), not from the port. It imports
# nothing of the port and no kernel; its state-dict keys and shapes are the
# port's, so the benchmark draws the same seeded weights into both. The heads
# (selector, refiner, uncertainty estimator, offset head) and their flow are
# the frozen reference's (`frontend.py`).
#
# Departures from DINOv3's vit_7b, each also the port's:
# - LayerNorms in float32 with the port's eps 1e-6 (DINOv3: a bf16 LayerNorm,
#   eps 1e-5), and flax's E[x^2] - mean^2 variance;
# - a float32 residual stream (DINOv3 trains under bf16 autocast);
# - no qkv bias, and so no masked k bias; biases on proj and on the SwiGLU;
# - RoPE's training augmentations (coordinate shift, jitter, rescale) off;
# - one CLS token and 4 storage tokens, then a BatchNorm (`feature_norm`) over
#   the patch tokens after the final LayerNorm: the frontend's head input;
# - float32 throughout, TF32 off (`harness/reference_run.py`); with the `FP8`
#   dtype the matrix-product operands are rounded to float8 e4m3 (the
#   benchmark's control), as in the frozen reference.
"""DINOv3 ViT-7B/16 learned frontend, plain float32.

Pre-norm block, for tokens x (1 CLS, 4 storage tokens, then the patches in
row-major order):

    q, k, v = split(W_qkv LN1(x))
    x <- x + g1 * (W_o Attn(R(q), R(k), v) + b_o)
    x <- x + g2 * (W3 (SiLU(W1 LN2(x) + b1) * (W2 LN2(x) + b2)) + b3)

Attn is softmax(q k^T / sqrt(hd)) v per head. R rotates each patch token's
q and k (not the CLS and storage tokens') by 2-D axial RoPE: for the patch
at row i, column j of a gh x gw grid, cy = 2(i + 1/2)/gh - 1 and
cx = 2(j + 1/2)/gw - 1, periods p_m = 100^(2m / (hd/2)) for
m = 0 .. hd/4 - 1, angles theta = 2 pi [cy / p, cx / p] (hd/2 values); the
head dimension's two halves (a, b) form the complex pairs a + i b, each
turned by e^(i theta). That is R(q) = q cos(theta') + rot(q) sin(theta'),
theta' the angles tiled twice, rot([a, b]) = [-b, a].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import frontend as frozen
from .layers import BatchNorm, LayerNorm, carrier, cast, default_generator, lecun_normal, normal
from .refiner import DescriptorRefiner
from .selector import KeypointSelector
from .uncertainty import UncertaintyEstimator

ROPE_BASE = 100.0
LAYERSCALE_INIT = 1e-5
NUM_STORAGE_TOKENS = 4


class Linear(nn.Module):
    """y = x W^T (+ b): weight (out, in); operands in ``dtype`` (``cast``),
    float32 sums."""

    def __init__(self, n_in: int, n_out: int, gen: torch.Generator, dtype, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((n_out, n_in), n_in, gen))
        self.register_parameter("bias", nn.Parameter(torch.zeros(n_out)) if bias else None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = cast(x, self.dtype) @ cast(self.weight, self.dtype).T
        return y if self.bias is None else y + self.bias.to(carrier(self.dtype))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator, dtype):
        super().__init__()
        self.w1 = Linear(dim, hidden, gen, dtype)
        self.w2 = Linear(dim, hidden, gen, dtype)
        self.w3 = Linear(hidden, dim, gen, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.w1(x)
        return self.w3(gate * torch.sigmoid(gate) * self.w2(x))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, dtype, qkv_bias: bool):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Linear(dim, 3 * dim, gen, dtype, bias=qkv_bias)
        self.proj = Linear(dim, dim, gen, dtype)

    def forward(self, x: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
        """``turn``: (patches, hd/2) complex64 rotations of the patch tokens,
        the last ``len(turn)`` tokens of ``x``."""
        B, N, D = x.shape
        h = self.num_heads
        hd = D // h
        q, k, v = self.qkv(x).float().split(D, dim=-1)
        q, k, v = (t.reshape(B, N, h, hd).transpose(1, 2) for t in (q, k, v))  # (B, h, N, hd)
        first = N - turn.shape[0]  # the first patch token

        def rotate(t):
            z = torch.complex(t[:, :, first:, : hd // 2], t[:, :, first:, hd // 2 :]) * turn
            return torch.cat([t[:, :, :first], torch.cat([z.real, z.imag], dim=-1)], dim=2)

        q, k = rotate(q), rotate(k)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        weights = cast(torch.softmax(scores, dim=-1), self.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, cast(v, self.dtype))
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class Block(nn.Module):
    def __init__(self, dim, num_heads, hidden, gen, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, gen, dtype, qkv_bias=False)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwiGLU(dim, hidden, gen, dtype)
        self.ls1 = LayerScale(dim, LAYERSCALE_INIT)
        self.ls2 = LayerScale(dim, LAYERSCALE_INIT)

    def forward(self, x: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1.gamma * self.attn(self.norm1(x), turn)
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


def rope_turns(gh: int, gw: int, head_dim: int, base: float, device) -> torch.Tensor:
    """(gh * gw, hd/2) complex64 e^(i theta) of each patch, row-major."""
    m = torch.arange(head_dim // 4, dtype=torch.float64, device=device)
    period = torch.tensor(float(base), dtype=torch.float64, device=device) ** (2 * m / (head_dim // 2))
    rows, cols = torch.meshgrid(torch.arange(gh, dtype=torch.float64, device=device),
                                torch.arange(gw, dtype=torch.float64, device=device), indexing="ij")
    cy = (2 * (rows + 0.5) / gh - 1).reshape(-1, 1)
    cx = (2 * (cols + 0.5) / gw - 1).reshape(-1, 1)
    theta = 2 * math.pi * torch.cat([cy / period, cx / period], dim=1)
    return torch.polar(torch.ones_like(theta), theta).to(torch.complex64)


class ViT7B(nn.Module):
    """(B, H, W, 3) -> (B, H/ps, W/ps, D) float32 batch-normed patch features."""

    def __init__(self, embed_dim, depth, num_heads, patch_size, mlp_ratio, dtype, gen):
        super().__init__()
        D, ps = embed_dim, patch_size
        self.embed_dim, self.patch_size, self.num_heads = D, ps, num_heads
        self.num_registers, self.dtype = NUM_STORAGE_TOKENS, dtype
        # Patch embedding: a stride-ps conv, weight OIHW.
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(lecun_normal((D, 3, ps, ps), 3 * ps * ps, gen))
        self.patch_embed.bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(normal((1, 1, D), 0.02, gen))
        self.register_tokens = nn.Parameter(normal((1, NUM_STORAGE_TOKENS, D), 0.02, gen))
        hidden = int(D * mlp_ratio)
        self.blocks = nn.ModuleList(Block(D, num_heads, hidden, gen, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(D)
        self.feature_norm = BatchNorm(D)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, H, W, _ = images.shape
        ps, D = self.patch_size, self.embed_dim
        gh, gw = H // ps, W // ps
        pe = self.patch_embed
        grid = F.conv2d(cast(images.permute(0, 3, 1, 2), self.dtype), cast(pe.weight, self.dtype), stride=ps)
        patches = grid.float().flatten(2).transpose(1, 2) + pe.bias  # (B, gh * gw, D)
        x = torch.cat([self.cls_token.expand(B, -1, -1), self.register_tokens.expand(B, -1, -1), patches], dim=1)
        turn = rope_turns(gh, gw, D // self.num_heads, ROPE_BASE, images.device)
        for block in self.blocks:
            x = block(x, turn)
        x = self.norm(x)[:, 1 + self.num_registers :]
        return self.feature_norm(x.reshape(B * gh * gw, D), train=train).reshape(B, gh, gw, D)


class LearnedFrontend(frozen.LearnedFrontend):
    """The frozen reference frontend's heads and flow on ``ViT7B``; takes
    the port's ``LearnedFrontend`` arguments for this architecture."""

    def __init__(self, embed_dim: int = 4096, depth: int = 40, num_heads: int = 32, patch_size: int = 16,
                 selector_hidden: int = 256, refiner_hidden: int = 384, refiner_layers: int = 4,
                 descriptor_dim: int = 128, estimator_hidden: int = 128, num_keypoints: int = 500,
                 nms_radius: int = 2, subpatch_refine: bool = False, mlp_ratio: float = 2.0,
                 block: str = "dinov3", dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        nn.Module.__init__(self)
        if block != "dinov3":
            raise ValueError(f"the ViT-7B/16 reference has DINOv3's block only, not {block!r}")
        gen = default_generator(generator)
        self.patch_size, self.num_keypoints, self.nms_radius = patch_size, num_keypoints, nms_radius
        self.subpatch_refine = subpatch_refine
        self.backbone = ViT7B(embed_dim, depth, num_heads, patch_size, mlp_ratio, dtype, gen)
        self.selector = KeypointSelector(embed_dim, selector_hidden, generator=gen)
        self.refiner = DescriptorRefiner(embed_dim, refiner_hidden, descriptor_dim, refiner_layers, generator=gen)
        self.estimator = UncertaintyEstimator(embed_dim + descriptor_dim, estimator_hidden, generator=gen)
        self.offset_head = frozen.OffsetHead(embed_dim + 9, 16, generator=gen) if subpatch_refine else None
        if device is not None:
            self.to(device)
