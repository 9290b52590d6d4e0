# Frozen copy of semantic_slam_master_tpu_torch/models/backbone.py (the port as of the
# benchmark's first version), rewritten to import nothing of the port and
# no kernel, and cut to what the benchmark calls: the plain reference that
# decides `correct`. Do not edit to follow the port.
"""ViT patch-feature backbone (port of ``models/backbone.py``): a ViT-S/16
with a CLS token and register tokens, returning the grid of patch
features after a BatchNorm (the reference's outlier suppression).

Dtypes as in the JAX module: bf16 operands on the matmul path, f32
LayerNorms, f32 attention scores and softmax (cast to bf16 before the
product with V). Attention is an explicit pair of matmuls around the
softmax, as the JAX einsums are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .image import resize_bilinear_nhwc
from .layers import BatchNorm, Dense, LayerNorm, carrier, cast, default_generator, gelu, lecun_normal, normal


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(dim, hidden, gen, dtype=dtype)
        self.fc2 = Dense(hidden, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x, sharded=True)), sharded=True)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.qkv = Dense(dim, 3 * dim, gen, dtype=dtype)
        self.proj = Dense(dim, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
        # bf16 operands, exact products and f32 sums: the JAX einsum's
        # preferred_element_type=f32.
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=x.device)
        attn = cast(torch.softmax(scores, dim=-1), self.dtype)
        out = torch.matmul(attn, cast(v, self.dtype))  # (B, heads, N, hd)
        return self.proj(out.transpose(1, 2).reshape(B, N, self.dim))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, gen, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), gen, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(cast(self.norm1(x), self.dtype))
        return x + self.mlp(cast(self.norm2(x), self.dtype))


class ViTBackbone(nn.Module):
    """ViT with CLS + register tokens emitting a (B, H/16, W/16, C) f32
    grid of batch-normed patch features. The positional embedding is
    stored on a ``pos_grid`` x ``pos_grid`` grid and bilinearly resized
    (``jax.image.resize``'s weights) to the input's patch grid."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 16, num_registers: int = 4, mlp_ratio: float = 4.0,
                 pos_grid: int = 28, dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        D, ps = embed_dim, patch_size
        self.embed_dim, self.patch_size, self.pos_grid = D, ps, pos_grid
        self.num_registers, self.dtype = num_registers, dtype
        # patch_embed as an OIHW conv weight, applied as one matmul over
        # the flattened (kh, kw, c) patches (stride = kernel, no padding).
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(
            lecun_normal((ps, ps, 3, D), ps * ps * 3, gen).permute(3, 2, 0, 1).contiguous()
        )
        self.patch_embed.bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(normal((1, 1, D), 0.02, gen))
        self.register_tokens = nn.Parameter(normal((1, num_registers, D), 0.02, gen))
        self.pos_embed = nn.Parameter(normal((1, pos_grid * pos_grid, D), 0.02, gen))
        self.blocks = nn.ModuleList(Block(D, num_heads, gen, mlp_ratio, dtype) for _ in range(depth))
        self.norm = LayerNorm(D)
        self.feature_norm = BatchNorm(D)
        if device is not None:
            self.to(device)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, gh * gw, C) patch tokens in ``dtype``."""
        B, H, W, _ = images.shape
        ps, D = self.patch_size, self.embed_dim
        if H % ps or W % ps:
            raise ValueError(f"image {H}x{W} is not a multiple of the {ps}-pixel patch")
        gh, gw = H // ps, W // ps
        patches = images.reshape(B, gh, ps, gw, ps, 3).permute(0, 1, 3, 2, 4, 5)
        patches = cast(patches.reshape(B, gh * gw, ps * ps * 3), self.dtype)
        w = cast(self.patch_embed.weight.permute(0, 2, 3, 1).reshape(D, ps * ps * 3), self.dtype)
        return torch.matmul(patches, w.T) + self.patch_embed.bias.to(carrier(self.dtype))

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, C); ``train`` normalises with the
        batch's statistics and moves the running ones."""
        B, H, W, _ = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        D, pg = self.embed_dim, self.pos_grid
        x = self.embed(images)
        pos = self.pos_embed
        if (gh, gw) != (pg, pg):
            pos = resize_bilinear_nhwc(pos.reshape(1, pg, pg, D), gh, gw).reshape(1, gh * gw, D)
        x = x.float() + pos
        tokens = torch.cat(
            [self.cls_token.expand(B, 1, D), self.register_tokens.expand(B, self.num_registers, D), x],
            dim=1,
        ).to(carrier(self.dtype))
        for block in self.blocks:
            tokens = block(tokens)
        tokens = self.norm(tokens)
        patches = tokens[:, 1 + self.num_registers :, :].float()
        flat = self.feature_norm(patches.reshape(B * gh * gw, D), train=train)
        return flat.reshape(B, gh, gw, D)


def patch_to_pixel(patch_coords: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """Patch-grid coords -> pixel coords at patch centres (patch * 16 + 8)."""
    return patch_coords * patch_size + patch_size / 2


