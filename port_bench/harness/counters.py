"""The yardstick's arithmetic: the least time each kernel could take for
the inputs it was given, and the model FLOPs behind ``mfu``.

The kernel counts are copied from ``chip_smoke.py`` (``fast_bounds``,
``unique_pixels``, ``patch_bytes_ops``, ``bound``): they count the work
the inputs need, whatever a kernel does with them. A bound is the larger
of bytes over the HBM bandwidth and operations over the float32 issue
rate. The FLOPs count the model's matrix products and convolutions from
its published shapes, two per multiply-add, whatever implements them.
"""

from __future__ import annotations

import math

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# Compares, subtracts, max, adds and rounds issue one per lane per cycle:
# 132 SMs x 128 lanes x 1.98 GHz, half the FMA-counted 67 TFLOP/s.
F32_OPS_PER_S = 132 * 128 * 1.98e9
# FAST-9 float32 work per pixel that runs the 16-point chain: 16 circle
# points x (difference, two compares, bright: subtract + max + add, dark:
# negate + subtract + max + add) plus the final select-add-select.
FAST_F32_OPS_PER_PIXEL = 16 * 10 + 3
# The 4-point early test every pixel runs: 4 differences, 8 compares.
FAST_EARLY_OPS_PER_PIXEL = 4 + 8
# Aligned patch gather: quantise (max, min, multiply, round) per gathered pixel.
PATCH_F32_OPS_PER_PIXEL = 4
PATCH = 32


def bound_s(bytes_moved: float, f32_ops: float) -> float:
    """Least seconds: the larger of the byte and the operation time."""
    return max(bytes_moved / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S)


def unique_pixels(idx: torch.Tensor, n_pixels: int) -> int:
    """Distinct source pixels that the flat indices ``idx`` (B, L) touch
    in B frames of ``n_pixels``: what a gather must read at least once,
    however much its windows overlap."""
    seen = torch.zeros((idx.shape[0], n_pixels), dtype=torch.bool, device=idx.device)
    seen.scatter_(1, idx, True)
    return int(seen.sum())


def fast_score_bound_s(px: int, n_pass: int) -> float:
    """fast_score over ``px`` pixels of which ``n_pass`` pass the 4-point
    test: each pixel read once and its score written once (8 bytes), the
    early test on every pixel and the 16-point chain on the passing ones."""
    return bound_s(8.0 * px, FAST_EARLY_OPS_PER_PIXEL * px + FAST_F32_OPS_PER_PIXEL * n_pass)


def aligned_patches_bound_s(img: torch.Tensor, xy: torch.Tensor) -> float:
    """One aligned gather of (B, N) keypoints from (B, H, W) f32 frames:
    the distinct f32 pixels its 32x32 windows cover, read once, 8 B of xy
    per keypoint, a 32x32 bf16 patch written per keypoint; the
    quantisation's operations."""
    B, H, W = img.shape
    N = xy.shape[1]
    c = torch.clamp(torch.nan_to_num(torch.round(xy), nan=0.0),
                    torch.tensor([15.0, 15.0], device=xy.device),
                    torch.tensor([W - 18.0, H - 17.0], device=xy.device)).to(torch.int64)
    d = torch.arange(PATCH, device=xy.device) - 15
    idx = ((c[..., 1, None, None] + d[:, None]) * W + c[..., 0, None, None] + d[None, :]).reshape(B, -1)
    n_read = unique_pixels(idx, H * W)
    nbytes = n_read * 4 + B * N * (8 + PATCH * PATCH * 2)
    return bound_s(nbytes, B * N * PATCH * PATCH * PATCH_F32_OPS_PER_PIXEL)


def gather_patches_bound_s(frames: int, keypoints: int, radius: int, patch_size: int) -> float:
    """The learned frontend's gather of ``keypoints`` windows of side
    2r+1 per frame, centred on distinct patches of a ``patch_size`` grid.
    Each window covers its own patch's cell, so the distinct pixels read
    are at least keypoints x patch_size^2 (f32); the windows are written
    once (f32) and each centre read (8 B). The read count is a floor, so
    the share this bound gives is a floor too."""
    side = 2 * radius + 1
    per_kp = patch_size * patch_size * 4 + side * side * 4 + 8
    return bound_s(frames * keypoints * per_kp, 0.0)


# Model FLOPs, two per multiply-add, from the configuration's shapes.

# d x hidden products of a ViT block's feed-forward, by ``model.ffn``.
FFN_PRODUCTS = {"gelu_mlp": 2, "swiglu": 3}


def dense(tokens: int, n_in: int, n_out: int) -> int:
    return 2 * tokens * n_in * n_out


def conv(out_pixels: int, n_in: int, n_out: int, k: int) -> int:
    return 2 * out_pixels * n_in * n_out * k * k


def vit_flops(height: int, width: int, embed_dim: int, depth: int, num_heads: int, patch_size: int,
              num_registers: int, mlp_ratio: float, ffn: str = "gelu_mlp") -> int:
    """ViT forward: patch embedding, then per block qkv, the two attention
    products (scores and their product with V, all heads), the output
    projection and the feed-forward block of hidden width ``mlp_ratio * d``:
    a GELU MLP's two d x hidden products, a SwiGLU's three (gate, up,
    down). Softmax, RoPE and LayerScale are elementwise and count 0."""
    patches = (height // patch_size) * (width // patch_size)
    t = patches + 1 + num_registers
    d = embed_dim
    hidden = int(d * mlp_ratio)
    block = dense(t, d, 3 * d) + 2 * (2 * t * t * d) + dense(t, d, d) + FFN_PRODUCTS[ffn] * dense(t, d, hidden)
    return dense(patches, patch_size * patch_size * 3, d) + depth * block


def heads_flops(height: int, width: int, embed_dim: int, patch_size: int, selector_hidden: int,
                refiner_hidden: int, refiner_layers: int, descriptor_dim: int, estimator_hidden: int,
                num_keypoints: int, subpatch_refine: bool, offset_hidden: int = 16) -> int:
    """The learned frontend's heads: the saliency selector over the patch
    grid, then per keypoint the descriptor refiner, the uncertainty
    estimator and (with sub-patch refinement) the offset head's context
    projection and three 3x3 convs over its (patch_size / 2 + 2) * 2 + 1
    window."""
    grid = (height // patch_size) * (width // patch_size)
    k = num_keypoints
    f = conv(grid, embed_dim, selector_hidden, 3) + dense(grid, selector_hidden, 1)
    f += dense(k, embed_dim, refiner_hidden) + (refiner_layers - 2) * 2 * dense(k, refiner_hidden, refiner_hidden)
    f += dense(k, refiner_hidden, descriptor_dim)
    e_in = embed_dim + descriptor_dim
    f += dense(k, e_in, estimator_hidden) + dense(k, estimator_hidden, estimator_hidden // 2)
    f += dense(k, estimator_hidden // 2, 1)
    if subpatch_refine:
        side = 2 * (patch_size // 2 + 2) + 1
        px = k * side * side
        f += dense(k, embed_dim + 9, offset_hidden)
        f += conv(px, 1, offset_hidden, 3) + conv(px, offset_hidden, offset_hidden, 3) + conv(px, offset_hidden, 1, 3)
    return f


def segmenter_flops(height: int, width: int, seg_width: int, num_classes: int) -> int:
    """The segmenter at 1/4-resolution output: three stride-2 3x3 stages,
    two dilated 3x3 at 1/8, the decoder's 3x3 over the skip concat at
    1/4, and the 1x1 classifier."""
    w = seg_width
    p2 = math.ceil(height / 2) * math.ceil(width / 2)
    p4 = math.ceil(height / 4) * math.ceil(width / 4)
    p8 = math.ceil(height / 8) * math.ceil(width / 8)
    return (conv(p2, 3, w, 3) + conv(p4, w, 2 * w, 3) + conv(p8, 2 * w, 4 * w, 3)
            + 2 * conv(p8, 4 * w, 4 * w, 3) + conv(p4, 6 * w, 2 * w, 3) + conv(p4, 2 * w, num_classes, 1))


def model_flops_per_frame(config: dict) -> int:
    """The configuration's model FLOPs per frame: the learned frontend
    (backbone and heads) and the segmenter; the SLAM loop counts 0."""
    cam = config["camera"]
    h, w = cam["height"], cam["width"]
    total = 0
    if config["frontend"] == "learned":
        m = config["model"]
        s = m["sizes"]
        total += vit_flops(h, w, s["embed_dim"], s["depth"], s["num_heads"], s["patch_size"],
                           m["num_registers"], m["mlp_ratio"], m.get("ffn", "gelu_mlp"))
        total += heads_flops(h, w, s["embed_dim"], s["patch_size"], s["selector_hidden"], s["refiner_hidden"],
                             s["refiner_layers"], s["descriptor_dim"], s["estimator_hidden"], s["num_keypoints"],
                             s["subpatch_refine"])
    if config.get("semantics") == "model":
        s = config["segmenter"]["sizes"]
        total += segmenter_flops(h, w, s["width"], s["num_classes"])
    return total
