"""ViT patch-feature backbone (port of ``models/backbone.py``): a ViT
with a CLS token and register tokens, returning the grid of patch
features after a BatchNorm (the reference's outlier suppression).

``block`` picks one of two blocks. ``"vit"`` (the default) is the JAX
module's ViT-S/16 block: a learned absolute position table resized to the
patch grid, a GELU MLP, a qkv bias, no LayerScale. ``"dinov3"`` is DINOv3's
ViT-7B/16 block (Simeoni et al., *DINOv3*, arXiv:2508.10104, Table 1;
``dinov3``'s ``vit_7b``): SwiGLU, RoPE of base ``ROPE_BASE``, LayerScale
starting at ``LAYERSCALE_INIT``, no qkv bias. Its pre-norm block:

    q, k, v = split(W_qkv . LN1(x) [+ b_qkv])
    x <- x + g1 * Proj(Attn(R(q), R(k), v))
    x <- x + g2 * (W3 (SiLU(W1 . LN2(x) + b1) * (W2 . LN2(x) + b2)) + b3)

with ``g1``, ``g2`` the LayerScale vectors (``ls1.gamma``, ``ls2.gamma``;
as DINOv3's ``ls2(mlp(x))``, ``g2`` scales ``b3`` too). The RoPE ``R``
rotates the patch tokens' q and k; the CLS and register tokens pass
unrotated. For the patch at row i, column j of a gh x gw grid:

    cy = 2 (i + 1/2) / gh - 1,   cx = 2 (j + 1/2) / gw - 1
    p_m = 100^(2m / (hd/2)),     m = 0 .. hd/4 - 1
    theta = 2 pi [cy/p_0 .. cy/p_{hd/4-1}, cx/p_0 .. cx/p_{hd/4-1}]   (hd/2 values, tiled twice to hd)
    R(q) = q cos(theta) + rot(q) sin(theta),   rot([a, b]) = [-b, a] over the halves of the head

There is no absolute position table in this block. DINOv3's coordinate
shift, jitter and rescale are training augmentations and are off. The
final LayerNorm runs over all tokens, then the patch tokens go through
``feature_norm``.

Dtypes as in the JAX module: bf16 operands on the matmul path, f32
LayerNorms, f32 attention scores and softmax (cast to bf16 before the
product with V); RoPE rotates the f32 copies of q and k that the scores
take. Attention is an explicit pair of matmuls around the softmax, as the
JAX einsums are. The residual stream is in the matmul dtype, or in f32
in the ``"dinov3"`` block: there ``g * branch`` is taken in f32, since a
bf16 stream rounds away every update smaller than 2^-8 of the stream (all
of them at DINOv3's initial g of 1e-5).

Each block records the device spans ``frontend.backbone.attn`` (LN1 to
the scaled residual update) and ``frontend.backbone.ffn`` (LN2 to its
update) in the port's recorder (``utils/profiling.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.functional import silu

from ..ops.image import resize_bilinear_nhwc
from ..utils import profiling
from .layers import BatchNorm, Dense, LayerNorm, default_generator, gelu, lecun_normal, normal


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(dim, hidden, gen, dtype=dtype)
        self.fc2 = Dense(hidden, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x, sharded=True)), sharded=True)


class SwiGLU(nn.Module):
    """DINOv3's ``SwiGLUFFN``: ``w3(silu(w1 x) * w2 x)``, ``w1`` the gate."""

    def __init__(self, dim: int, hidden: int, gen: torch.Generator, dtype=torch.bfloat16):
        super().__init__()
        self.w1 = Dense(dim, hidden, gen, dtype=dtype)
        self.w2 = Dense(dim, hidden, gen, dtype=dtype)
        self.w3 = Dense(hidden, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(silu(self.w1(x)) * self.w2(x))


BLOCKS = ("vit", "dinov3")
ROPE_BASE = 100.0  # DINOv3's RoPE base
LAYERSCALE_INIT = 1e-5  # DINOv3's initial LayerScale


class LayerScale(nn.Module):
    """``gamma * x`` per channel, in f32; ``gamma`` starts at ``init``."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() * self.gamma


def rope_tables(gh: int, gw: int, head_dim: int, device=None):
    """(cos, sin) of the RoPE angles of a gh x gw patch grid, each
    (gh * gw, head_dim) f32, patches in row-major order; the angles are
    taken in f64."""
    if head_dim % 4:
        raise ValueError(f"RoPE needs a head size divisible by 4, not {head_dim}")
    f64 = dict(dtype=torch.float64, device=device)
    q = head_dim // 4
    periods = ROPE_BASE ** (2 * torch.arange(q, **f64) / (head_dim // 2))
    cy = 2 * (torch.arange(gh, **f64) + 0.5) / gh - 1
    cx = 2 * (torch.arange(gw, **f64) + 0.5) / gw - 1
    ay = (cy[:, None] / periods)[:, None, :].expand(gh, gw, q)
    ax = (cx[:, None] / periods)[None, :, :].expand(gh, gw, q)
    theta = 2 * math.pi * torch.cat([ay, ax], dim=-1).reshape(gh * gw, 2 * q)
    theta = torch.cat([theta, theta], dim=-1)
    return theta.cos().float(), theta.sin().float()


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x cos + rot(x) sin`` over the last axis, ``rot([a, b]) = [-b, a]``."""
    a, b = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-b, a], dim=-1) * sin


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, dtype=torch.bfloat16,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.qkv = Dense(dim, 3 * dim, gen, dtype=dtype, bias=qkv_bias)
        self.proj = Dense(dim, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        """``rope``: None, or the (cos, sin) tables of the patch tokens,
        which are the last ``len(cos)`` of ``x``'s tokens."""
        B, N, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
        # bf16 operands, exact products and f32 sums: the JAX einsum's
        # preferred_element_type=f32.
        q, k = q.float(), k.float()
        if rope is not None:
            cos, sin = rope
            n = N - cos.shape[0]
            q = torch.cat([q[:, :, :n], rope_apply(q[:, :, n:], cos, sin)], dim=2)
            k = torch.cat([k[:, :, :n], rope_apply(k[:, :, n:], cos, sin)], dim=2)
        scores = torch.matmul(q, k.transpose(-1, -2))
        del q, k  # the f32 copies end here, before the softmax's peak
        scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=x.device)
        attn = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v.to(self.dtype))  # (B, heads, N, hd)
        return self.proj(out.transpose(1, 2).reshape(B, N, self.dim))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, gen: torch.Generator, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16, block: str = "vit"):
        super().__init__()
        dinov3 = block == "dinov3"
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, gen, dtype, qkv_bias=not dinov3)
        self.norm2 = LayerNorm(dim)
        self.mlp = (SwiGLU if dinov3 else MlpBlock)(dim, int(dim * mlp_ratio), gen, dtype)
        if dinov3:
            self.ls1 = LayerScale(dim, LAYERSCALE_INIT)
            self.ls2 = LayerScale(dim, LAYERSCALE_INIT)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        with profiling.span("frontend.backbone.attn", device=x.device):
            x = x + _scaled(self.ls1, self.attn(self.norm1(x).to(self.dtype), rope))
        with profiling.span("frontend.backbone.ffn", device=x.device):
            return x + _scaled(self.ls2, self.mlp(self.norm2(x).to(self.dtype)))


def _scaled(ls: LayerScale | None, y: torch.Tensor) -> torch.Tensor:
    return y if ls is None else ls(y)


class ViTBackbone(nn.Module):
    """ViT with CLS + register tokens emitting a (B, H/16, W/16, C) f32
    grid of batch-normed patch features. With ``block="vit"`` the
    positional embedding is stored on a ``pos_grid`` x ``pos_grid`` grid
    and bilinearly resized (``jax.image.resize``'s weights) to the input's
    patch grid; with ``"dinov3"`` RoPE rotates q and k and there is no
    table. The feed-forward's hidden width is ``mlp_ratio`` x d."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 16, num_registers: int = 4, mlp_ratio: float = 4.0,
                 pos_grid: int = 28, block: str = "vit", dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"block {block!r} is not one of {BLOCKS}")
        gen = default_generator(generator)
        D, ps = embed_dim, patch_size
        self.embed_dim, self.patch_size, self.pos_grid = D, ps, pos_grid
        self.num_registers, self.dtype = num_registers, dtype
        self.num_heads, self.rope = num_heads, block == "dinov3"
        self.stream_dtype = torch.float32 if self.rope else dtype
        # patch_embed as an OIHW conv weight, applied as one matmul over
        # the flattened (kh, kw, c) patches (stride = kernel, no padding).
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(
            lecun_normal((ps, ps, 3, D), ps * ps * 3, gen).permute(3, 2, 0, 1).contiguous()
        )
        self.patch_embed.bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(normal((1, 1, D), 0.02, gen))
        self.register_tokens = nn.Parameter(normal((1, num_registers, D), 0.02, gen))
        if self.rope:
            self.pos_embed = None
        else:
            self.pos_embed = nn.Parameter(normal((1, pos_grid * pos_grid, D), 0.02, gen))
        self.blocks = nn.ModuleList(Block(D, num_heads, gen, mlp_ratio, dtype, block) for _ in range(depth))
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
        patches = patches.reshape(B, gh * gw, ps * ps * 3).to(self.dtype)
        w = self.patch_embed.weight.permute(0, 2, 3, 1).reshape(D, ps * ps * 3).to(self.dtype)
        return torch.matmul(patches, w.T) + self.patch_embed.bias.to(self.dtype)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, C); ``train`` normalises with the
        batch's statistics and moves the running ones."""
        B, H, W, _ = images.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        D, pg = self.embed_dim, self.pos_grid
        x = self.embed(images).float()
        rope = None
        if self.rope:
            rope = rope_tables(gh, gw, D // self.num_heads, device=images.device)
        else:
            pos = self.pos_embed
            if (gh, gw) != (pg, pg):
                pos = resize_bilinear_nhwc(pos.reshape(1, pg, pg, D), gh, gw).reshape(1, gh * gw, D)
            x = x + pos
        tokens = torch.cat(
            [self.cls_token.expand(B, 1, D), self.register_tokens.expand(B, self.num_registers, D), x],
            dim=1,
        ).to(self.stream_dtype)
        for block in self.blocks:
            tokens = block(tokens, rope)
        tokens = self.norm(tokens)
        patches = tokens[:, 1 + self.num_registers :, :].float()
        flat = self.feature_norm(patches.reshape(B * gh * gw, D), train=train)
        return flat.reshape(B, gh, gw, D)


def patch_to_pixel(patch_coords: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """Patch-grid coords -> pixel coords at patch centres (patch * 16 + 8)."""
    return patch_coords * patch_size + patch_size / 2


def pixel_to_patch(pixel_coords: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """Inverse of :func:`patch_to_pixel`."""
    return (pixel_coords - patch_size / 2) / patch_size


def convert_timm_state_dict(state_dict: dict, depth: int = 12, pos_grid: int = 28) -> dict:
    """A timm DINOv3 ViT state dict -> a ``ViTBackbone`` state dict, for
    deployments that ship pretrained weights. timm's layouts are already
    PyTorch's (conv OIHW, linear (out, in), fused [q; k; v] rows), so only
    names change: ``patch_embed.proj`` -> ``patch_embed``, ``reg_token`` ->
    ``register_tokens``; the last ``pos_grid``^2 rows of ``pos_embed`` are
    kept (prefix-token embeddings dropped). ``feature_norm`` starts fresh:
    the identity, as the JAX converter leaves it."""

    def t(x):
        return torch.as_tensor(x).detach().to(torch.float32).clone()

    embed_dim = int(t(state_dict["cls_token"]).shape[-1])
    sd = {
        "patch_embed.weight": t(state_dict["patch_embed.proj.weight"]),
        "patch_embed.bias": t(state_dict["patch_embed.proj.bias"]),
        "cls_token": t(state_dict["cls_token"]),
        "register_tokens": t(state_dict.get("reg_token", state_dict.get("register_tokens"))),
        "pos_embed": t(state_dict["pos_embed"])[:, -pos_grid * pos_grid :].contiguous(),
        "norm.weight": t(state_dict["norm.weight"]),
        "norm.bias": t(state_dict["norm.bias"]),
        "feature_norm.weight": torch.ones(embed_dim),
        "feature_norm.bias": torch.zeros(embed_dim),
        "feature_norm.running_mean": torch.zeros(embed_dim),
        "feature_norm.running_var": torch.ones(embed_dim),
    }
    for i in range(depth):
        for leaf in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            for kind in ("weight", "bias"):
                sd[f"blocks.{i}.{leaf}.{kind}"] = t(state_dict[f"blocks.{i}.{leaf}.{kind}"])
    return sd
