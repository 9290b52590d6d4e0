"""The learned feature frontend (port of ``models/frontend.py``):
backbone -> saliency -> keypoints -> (sub-patch offsets) -> descriptors
-> confidence; the trainer calls its stages one by one.

With ``subpatch_refine`` the keypoints move off the 16-pixel patch
centres by ``OffsetHead``'s soft-argmax over a 21x21 intensity window
around each one; those windows come from ``ops.sampling.gather_patches``,
which on a CUDA tensor is the hand-written kernel
``csrc/gather_patches.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.sampling import bilinear_sample, gather_patches, nearest_sample
from ..utils import profiling
from .backbone import ViTBackbone, patch_to_pixel
from .layers import Conv, Dense, default_generator, gelu
from .refiner import DescriptorRefiner
from .selector import KeypointSelector, select_keypoints
from .uncertainty import UncertaintyEstimator


class FrontendOutput(NamedTuple):
    keypoints_px: torch.Tensor  # (B, K, 2) pixel coords
    keypoints_patch: torch.Tensor  # (B, K, 2) patch coords
    descriptors: torch.Tensor  # (B, K, D) L2-normalised
    scores: torch.Tensor  # (B, K) saliency at keypoints
    confidence: torch.Tensor  # (B, K) uncertainty-head confidence
    valid: torch.Tensor  # (B, K)
    saliency: torch.Tensor  # (B, H, W, 1) full map
    features: torch.Tensor  # (B, H, W, C) backbone grid


class OffsetHead(nn.Module):
    """Soft-argmax sub-patch keypoint localisation: a small conv stack
    scores every pixel of the keypoint's standardised intensity window
    (modulated by the ViT feature and 3x3 saliency context), commits to
    the strongest peak (argmax with a -1e-6 d^2 tie prior towards the
    centre; ``torch.argmax`` returns the first maximum, as ``jnp.argmax``)
    and returns the softmax-expected (dx, dy) inside a
    (2 * local_radius + 1)^2 box around it, in window pixels. The last
    conv starts at zero, so a fresh head returns exactly 0."""

    def __init__(self, ctx_dim: int, hidden_dim: int = 16, temperature: float = 0.5,
                 local_radius: int = 4, device=None, generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.temperature, self.local_radius = temperature, local_radius
        self.ctx = Dense(ctx_dim, hidden_dim, gen)
        self.conv1 = Conv(1, hidden_dim, 3, gen)
        self.conv2 = Conv(hidden_dim, hidden_dim, 3, gen)
        self.conv3 = Conv(hidden_dim, 1, 3, gen, init="zeros")
        if device is not None:
            self.to(device)

    def forward(self, pixel_patch: torch.Tensor, local_feats: torch.Tensor, sal_patch: torch.Tensor):
        """pixel_patch (B, K, P, P), local_feats (B, K, C), sal_patch
        (B, K, 9) -> (B, K, 2) expected (dx, dy) in window pixels."""
        B, K, P, _ = pixel_patch.shape
        dev = pixel_patch.device
        x = pixel_patch.reshape(B * K, 1, P, P)
        ctx = self.ctx(torch.cat([local_feats.float(), sal_patch.float()], dim=-1))
        x = gelu(self.conv1(x) + ctx.reshape(B * K, -1, 1, 1))
        x = gelu(self.conv2(x))
        flat = self.conv3(x).reshape(B * K, P * P) / self.temperature
        d2 = (torch.arange(P, device=dev) - (P - 1) / 2.0) ** 2
        prior = (-1e-6 * (d2[:, None] + d2[None, :])).reshape(P * P)
        peak = torch.argmax(flat + prior, dim=-1)
        py = torch.div(peak, P, rounding_mode="floor")[:, None]
        px = (peak % P)[:, None]
        iy = torch.arange(P, device=dev)[None, :]
        near_y = (iy - py).abs() <= self.local_radius
        near_x = (iy - px).abs() <= self.local_radius
        mask = (near_y[:, :, None] & near_x[:, None, :]).reshape(B * K, P * P)
        flat = torch.where(mask, flat, torch.full_like(flat, float("-inf")))
        w = torch.softmax(flat, dim=-1).reshape(B, K, P, P)
        pos = torch.arange(P, dtype=w.dtype, device=dev) - (P - 1) / 2.0
        dx = torch.einsum("bkyx,x->bk", w, pos)
        dy = torch.einsum("bkyx,y->bk", w, pos)
        return torch.stack([dx, dy], dim=-1)


class LearnedFrontend(nn.Module):
    """End-to-end learned frontend with the JAX module's defaults
    (ViT-S/16, 500 keypoints, 128-d descriptors). ``dtype`` is the
    backbone's matmul dtype; the heads run in f32. ``mlp_ratio`` and
    ``block`` go to ``ViTBackbone`` (DINOv3 ViT-7B/16: 2.0, ``"dinov3"``)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6, patch_size: int = 16,
                 pos_grid: int = 28, selector_hidden: int = 256, refiner_hidden: int = 384,
                 refiner_layers: int = 4, descriptor_dim: int = 128, estimator_hidden: int = 128,
                 num_keypoints: int = 500, nms_radius: int = 2, subpatch_refine: bool = False,
                 mlp_ratio: float = 4.0, block: str = "vit", dtype=torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = default_generator(generator)
        self.patch_size, self.num_keypoints, self.nms_radius = patch_size, num_keypoints, nms_radius
        self.subpatch_refine = subpatch_refine
        self.backbone = ViTBackbone(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                                    patch_size=patch_size, mlp_ratio=mlp_ratio, pos_grid=pos_grid,
                                    block=block, dtype=dtype, generator=gen)
        self.selector = KeypointSelector(embed_dim, selector_hidden, generator=gen)
        self.refiner = DescriptorRefiner(embed_dim, refiner_hidden, descriptor_dim, refiner_layers, generator=gen)
        self.estimator = UncertaintyEstimator(embed_dim + descriptor_dim, estimator_hidden, generator=gen)
        # Only a model that refines has offset-head parameters, as in flax.
        self.offset_head = OffsetHead(embed_dim + 9, 16, generator=gen) if subpatch_refine else None
        if device is not None:
            self.to(device)

    def features_and_saliency(self, images: torch.Tensor, train: bool = False):
        """Backbone grid + saliency map (NaN saliency -> 0.5); ``train`` is
        the backbone BatchNorm's training mode."""
        feats = self.backbone(images, train=train)
        return feats, self.saliency_of(feats)

    def saliency_of(self, feats: torch.Tensor) -> torch.Tensor:
        """The selector's saliency map of a backbone grid (NaN -> 0.5)."""
        saliency = self.selector(feats)
        return torch.where(torch.isfinite(saliency), saliency, torch.full_like(saliency, 0.5))

    def refine_at(self, feats, saliency, images, keypoints_patch):
        """Patch-centre coords + OffsetHead offsets from the standardised
        21x21 intensity window, the local feature and the 3x3 saliency."""
        sal = saliency[..., 0] if saliency.ndim == 4 else saliency
        neigh = torch.stack(
            [
                nearest_sample(sal, keypoints_patch + torch.tensor([dx, dy], device=sal.device))
                for dy in (-1.0, 0.0, 1.0)
                for dx in (-1.0, 0.0, 1.0)
            ],
            dim=-1,
        )  # (B, K, 9)
        local = bilinear_sample(feats, keypoints_patch)
        gray = torch.mean(images.float(), dim=-1)  # (B, H, W)
        centers_px = patch_to_pixel(keypoints_patch, self.patch_size)
        r = self.patch_size // 2 + 2
        patches = gather_patches(gray, centers_px, r)  # (B, K, P, P)
        mu = torch.mean(patches, dim=(-1, -2), keepdim=True)
        sd = torch.std(patches, dim=(-1, -2), keepdim=True, correction=0)
        patches = (patches - mu) / (sd + 1e-5)
        off_px = self.offset_head(patches, local, neigh)
        return keypoints_patch + off_px / self.patch_size

    def describe_at(self, feats, keypoints_patch):
        """Bilinear feature sampling + descriptor refinement + confidence."""
        sampled = bilinear_sample(feats, keypoints_patch)
        desc = self.refiner(sampled)
        conf = self.estimator(sampled, desc)[..., 0]
        return sampled, desc, conf

    def forward(self, images: torch.Tensor) -> FrontendOutput:
        """(B, H, W, 3) normalised RGB -> FrontendOutput. Recorded as the
        device spans ``frontend.backbone`` (the ViT, with its blocks'
        ``frontend.backbone.attn`` and ``frontend.backbone.ffn`` inside) and
        ``frontend.heads`` (selector, top-k, sub-patch refinement,
        descriptors, confidence)."""
        with profiling.span("frontend.backbone", device=images.device):
            feats = self.backbone(images)
        with profiling.span("frontend.heads", device=images.device):
            saliency = self.saliency_of(feats)
            kp = select_keypoints(saliency, num_keypoints=self.num_keypoints, nms_radius=self.nms_radius)
            xy = self.refine_at(feats, saliency, images, kp.xy) if self.subpatch_refine else kp.xy
            _, desc, conf = self.describe_at(feats, xy)
            return FrontendOutput(
                keypoints_px=patch_to_pixel(xy, self.patch_size),
                keypoints_patch=xy,
                descriptors=desc,
                scores=kp.score,
                confidence=conf,
                valid=kp.valid,
                saliency=saliency,
                features=feats,
            )


def tiny_frontend(**overrides) -> LearnedFrontend:
    """A small config for tests (2-block ViT, 64-d), as the JAX package's."""
    cfg = dict(
        embed_dim=64, depth=2, num_heads=2, selector_hidden=32, refiner_hidden=64,
        refiner_layers=3, descriptor_dim=32, estimator_hidden=32, num_keypoints=64, pos_grid=8,
    )
    cfg.update(overrides)
    return LearnedFrontend(**cfg)
