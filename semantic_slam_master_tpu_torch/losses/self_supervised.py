"""The self-supervised training losses (port of
``losses/self_supervised.py``): batched InfoNCE over padded match lists
(plain, or with safe-radius, cross-image and hardest-negative mining),
descriptor variance and decorrelation, saliency repeatability,
peakiness, activation, edge awareness and sparsity, the GT depth + pose
warp that pairs keypoints, and the warp-consistency localisation loss.

Where JAX takes ``jnp.max`` / ``jnp.maximum`` / ``jnp.clip`` of a value
that carries gradient, this module takes ``torch.amax`` /
``torch.maximum`` / ``torch.minimum``: they split the gradient at a tie as
JAX does (``max(dim).values`` and ``torch.clamp`` pass it whole to one
side). Where JAX sums ``x * mask.astype(float)``, this module sums
``where(mask, x, 0)``: under ``jit`` XLA rewrites the product into that
select, so a masked-out NaN (a keypoint on NaN depth) drops out of the
value, while its gradient still comes back NaN through the chain rule.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.image import avg_pool_to, rgb_to_gray, sobel_magnitude
from ..ops.sampling import nearest_sample

DEFAULT_WEIGHTS: Dict[str, float] = {
    "desc": 8.0,
    "repeat": 0.3,
    "variance": 0.5,
    "peakiness": 0.1,
    "activation": 0.05,
    "edge": 0.3,
    "sparsity": 0.3,
}


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def relu_tie_half(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``: half the gradient at x == 0."""
    return torch.maximum(x, _scalar(x, 0.0))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, half the gradient at either edge."""
    return torch.minimum(torch.maximum(x, _scalar(x, lo)), _scalar(x, hi))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) rows at (B, P) indices -> (B, P, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    mx = torch.amax(logits, dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(logits - mx), dim=-1)) + mx[..., 0]


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x * mask.astype(x.dtype)`` as XLA compiles it: ``where(mask, x, 0)``."""
    return torch.where(mask, x, 0.0)


def _reduce_pairs(x: torch.Tensor, pair_valid: torch.Tensor, fallback: float) -> torch.Tensor:
    """Mean over valid pairs per image, then over images with >= 1 pair;
    ``fallback`` when no image has one."""
    cnt = torch.sum(pair_valid.to(x.dtype), dim=-1)
    per_image = torch.sum(masked(x, pair_valid), dim=-1) / torch.clamp(cnt, min=1.0)
    has_pairs = cnt > 0
    n_img = torch.sum(has_pairs)
    mean = torch.sum(torch.where(has_pairs, per_image, 0.0)) / torch.clamp(n_img, min=1)
    return torch.where(n_img > 0, mean, _scalar(mean, fallback))


def descriptor_matching_loss(desc1, desc2, pairs, pair_valid, temperature: float = 0.10,
                             fallback: float = 0.1) -> torch.Tensor:
    """InfoNCE over matched pairs: for each valid pair [i, j], cross-entropy
    of <desc1_i, every desc2> / T (clipped to +/-50) with target j.
    desc (B, N, D) unit rows; pairs (B, P, 2); pair_valid (B, P)."""
    anchors = _take_rows(desc1, pairs[..., 0])
    logits = clip(torch.einsum("bpd,bnd->bpn", anchors, desc2) / temperature, -50.0, 50.0)
    target = torch.gather(logits, -1, pairs[..., 1:2])[..., 0]
    return _reduce_pairs(_logsumexp(logits) - target, pair_valid, fallback)


def descriptor_matching_loss_hard(desc1, desc2, pairs, pair_valid, neg_ok, valid2=None,
                                  temperature: float = 0.10, cross_image: bool = True,
                                  hard_margin: float = 0.2, fallback: float = 0.1):
    """InfoNCE with hard-negative mining: negatives limited to ``neg_ok``
    (B, P, N) (outside the safe radius of the true correspondence), valid
    frame-2 descriptors of the other batch images join the pool, and a
    hardest-negative margin relu(margin - pos + max_neg) is returned
    beside the CE, both reduced as :func:`descriptor_matching_loss`."""
    B, N, D = desc2.shape
    P = pairs.shape[1]
    j_idx = pairs[..., 1]
    anchors = _take_rows(desc1, pairs[..., 0])
    sims = torch.einsum("bpd,bnd->bpn", anchors, desc2)
    pos = torch.gather(sims, -1, j_idx[..., None])[..., 0]
    allowed = neg_ok & ~F.one_hot(j_idx, N).bool()
    if valid2 is not None:
        allowed = allowed & valid2[:, None, :]

    def _logits(s):
        return clip(s / temperature, -50.0, 50.0)

    pos_logit = _logits(pos)
    logit_list = [pos_logit[..., None], torch.where(allowed, _logits(sims), -1e9)]
    max_neg = torch.amax(torch.where(allowed, sims, -1.0), dim=-1)
    if cross_image and B > 1:
        cross = torch.einsum("bpd,cnd->bpcn", anchors, desc2)
        allow_c = ~torch.eye(B, dtype=torch.bool, device=desc2.device)[:, None, :, None]
        if valid2 is not None:
            allow_c = allow_c & valid2[None, None, :, :]
        logit_list.append(torch.where(allow_c, _logits(cross), -1e9).reshape(B, P, B * N))
        max_neg = torch.maximum(max_neg, torch.amax(torch.where(allow_c, cross, -1.0), dim=(-2, -1)))
    ce = _logsumexp(torch.cat(logit_list, dim=-1)) - pos_logit
    hard = relu_tie_half(hard_margin - pos + max_neg)
    return _reduce_pairs(ce, pair_valid, fallback), _reduce_pairs(hard, pair_valid, 0.0)


def descriptor_variance_loss(descriptors, valid=None, min_variance: float = 0.005) -> torch.Tensor:
    """Hinge on the mean per-dimension (unbiased) variance of (B, N, D)."""
    B, N, D = descriptors.shape
    flat = descriptors.reshape(B * N, D)
    if valid is None:
        mean = flat.mean(dim=0)
        var = torch.sum((flat - mean) ** 2, dim=0) / max(B * N - 1, 1)
    else:
        m = valid.reshape(B * N, 1)
        cnt = torch.clamp(torch.sum(m.to(flat.dtype)), min=2.0)
        mean = torch.sum(masked(flat, m), dim=0) / cnt
        var = torch.sum(masked((flat - mean) ** 2, m), dim=0) / (cnt - 1.0)
    return relu_tie_half(min_variance - var.mean())


def descriptor_decorrelation_loss(descriptors) -> torch.Tensor:
    """Mean squared off-diagonal correlation of the descriptor dimensions."""
    B, N, D = descriptors.shape
    flat = descriptors.reshape(B * N, D)
    centered = flat - flat.mean(dim=0, keepdim=True)
    normed = centered / (centered.std(dim=0, keepdim=True, correction=1) + 1e-6)
    eye = torch.eye(D, dtype=flat.dtype, device=flat.device)
    off = (normed.T @ normed / (B * N) - eye) ** 2
    return torch.sum(off * (1.0 - eye)) / (D * (D - 1))


def repeatability_loss(saliency1, saliency2) -> torch.Tensor:
    """MSE between the two frames' saliency maps."""
    return torch.mean((saliency1 - saliency2) ** 2)


def peakiness_loss(saliency, target_variance: float = 0.22) -> torch.Tensor:
    """(mean per-image biased variance - target)^2."""
    var = saliency.reshape(saliency.shape[0], -1).var(dim=1, correction=0)
    return (var.mean() - target_variance) ** 2


def activation_loss(saliency, target_mean: float = 0.35) -> torch.Tensor:
    """(global mean saliency - target)^2."""
    return (saliency.mean() - target_mean) ** 2


def edge_awareness_loss(saliency, images) -> torch.Tensor:
    """Negative Pearson correlation of saliency (B, h, w[, 1]) with the
    Sobel magnitude of the (B, H, W, 3) images, normalised by its global
    max and average-pooled to (h, w)."""
    if saliency.ndim == 4:
        saliency = saliency[..., 0]
    B, h, w = saliency.shape
    edge = sobel_magnitude(rgb_to_gray(images))
    edge = edge / (torch.amax(edge) + 1e-8)
    e = avg_pool_to(edge, h, w).reshape(B, -1)
    s = saliency.reshape(B, -1)
    ec = e - e.mean(dim=1, keepdim=True)
    sc = s - s.mean(dim=1, keepdim=True)
    corr = torch.sum(ec * sc, dim=1) / (torch.sqrt(torch.sum(ec**2, dim=1) * torch.sum(sc**2, dim=1)) + 1e-8)
    return -corr.mean()


def spatial_sparsity_loss(saliency, target_variation: float = 0.15, high_threshold: float = 0.6,
                          max_high_ratio: float = 0.20, penalty_weight: float = 2.0) -> torch.Tensor:
    """Hinge on the mean spatial gradient plus a penalty on the share of
    saliency above ``high_threshold``."""
    if saliency.ndim == 4:
        saliency = saliency[..., 0]
    gx = saliency[:, :, 1:] - saliency[:, :, :-1]
    gy = saliency[:, 1:, :] - saliency[:, :-1, :]
    variation = (torch.abs(gx).mean() + torch.abs(gy).mean()) / 2.0
    sparsity = relu_tie_half(target_variation - variation)
    high_ratio = (saliency > high_threshold).to(saliency.dtype).mean()
    return sparsity + relu_tie_half(high_ratio - max_high_ratio) * penalty_weight


def warp_points_depth(uv1, depth1, K, T_21, K2=None, min_depth: float = 0.05):
    """Frame-1 pixels (B, K, 2) through their nearest-sampled depth (B, H, W)
    and T_21 (B, 4, 4) into frame 2 with intrinsics K2 (default K; each
    (3, 3) or (B, 3, 3)) -> ((B, K, 2) pixels, (B, K) validity: depth and
    z2 above ``min_depth``, inside frame 2)."""
    B = uv1.shape[0]
    H, W = depth1.shape[-2:]
    d = nearest_sample(depth1, uv1)
    K = torch.as_tensor(K, dtype=uv1.dtype, device=uv1.device).expand(B, 3, 3)
    X1 = torch.stack([
        (uv1[..., 0] - K[:, None, 0, 2]) / K[:, None, 0, 0] * d,
        (uv1[..., 1] - K[:, None, 1, 2]) / K[:, None, 1, 1] * d,
        d,
    ], dim=-1)
    R = T_21[:, :3, :3].to(uv1.dtype)
    t = T_21[:, :3, 3].to(uv1.dtype)
    X2 = torch.einsum("bij,bkj->bki", R, X1) + t[:, None, :]
    z2 = X2[..., 2]
    z_safe = torch.where(z2 > min_depth, z2, 1.0)
    Kp = K if K2 is None else torch.as_tensor(K2, dtype=uv1.dtype, device=uv1.device).expand(B, 3, 3)
    u2 = Kp[:, None, 0, 0] * X2[..., 0] / z_safe + Kp[:, None, 0, 2]
    v2 = Kp[:, None, 1, 1] * X2[..., 1] / z_safe + Kp[:, None, 1, 2]
    ok = (d > min_depth) & (z2 > min_depth) & (u2 >= 0.0) & (u2 <= W - 1.0) & (v2 >= 0.0) & (v2 <= H - 1.0)
    return torch.stack([u2, v2], dim=-1), ok


def gt_match_pairs(uv1, uv2, valid1, valid2, depth1, K, T_21, K2=None, radius: float = 6.0,
                   safe_radius: float | None = None):
    """Pair each frame-1 keypoint with the frame-2 keypoint nearest its
    depth + pose warp, valid within ``radius`` px: ((B, K, 2) [i, j],
    (B, K) validity), and with ``safe_radius`` the (B, K1, K2) mask of
    frame-2 keypoints farther than it from the warped point."""
    warped, ok = warp_points_depth(uv1, depth1, K, T_21, K2=K2)
    d2 = torch.sum((warped[:, :, None, :] - uv2[:, None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid2[:, None, :], d2, float("inf"))
    j = torch.argmin(d2, dim=-1)
    dmin = torch.amin(d2, dim=-1)
    pair_valid = valid1 & ok & (dmin <= radius * radius)
    i = torch.arange(j.shape[1], device=j.device).expand_as(j)
    pairs = torch.stack([i, j], dim=-1)
    if safe_radius is None:
        return pairs, pair_valid
    return pairs, pair_valid, d2 > safe_radius * safe_radius


def localization_loss(uv1, uv2_matched, valid, depth1, K, T_21, huber_delta: float = 4.0,
                      min_depth: float = 0.05, max_residual: float | None = None, K2=None) -> torch.Tensor:
    """Mean Huber distance, over valid matches, between each refined
    frame-1 keypoint warped into frame 2 and its matched frame-2 keypoint;
    residuals of ``max_residual`` px or more are left out."""
    warped, ok_w = warp_points_depth(uv1, depth1, K, T_21, K2=K2, min_depth=min_depth)
    ok = valid & ok_w
    r = torch.sqrt(torch.sum((warped - uv2_matched) ** 2, dim=-1) + 1e-12)
    if max_residual is not None:
        ok = ok & (r < max_residual)
    hub = torch.where(r < huber_delta, 0.5 * r**2 / huber_delta, r - 0.5 * huber_delta)
    return torch.sum(masked(hub, ok)) / torch.clamp(torch.sum(ok.to(uv1.dtype)), min=1.0)


class LossBundle(NamedTuple):
    total: torch.Tensor
    components: Dict[str, torch.Tensor]


def guard(x: torch.Tensor, fallback: float) -> torch.Tensor:
    """``x`` where finite, else ``fallback`` (``jnp.where(isfinite(x), ...)``)."""
    return torch.where(torch.isfinite(x), x, _scalar(x, fallback))


def total_loss(desc1, desc2, pairs, pair_valid, saliency1, saliency2, rgb1, weights: Dict[str, float] | None = None,
               temperature: float = 0.10, min_variance: float = 0.005, target_variance: float = 0.22,
               target_mean: float = 0.35, sparsity_penalty: float = 2.0, neg_ok: Optional[torch.Tensor] = None,
               valid2: Optional[torch.Tensor] = None, cross_image: bool = True,
               hard_margin: float = 0.2) -> LossBundle:
    """The weighted seven-loss sum with each term's non-finite fallback;
    with ``neg_ok`` the desc term is :func:`descriptor_matching_loss_hard`
    and a ``hard`` margin term joins under ``weights['hard']``."""
    w = dict(DEFAULT_WEIGHTS)
    if weights:
        w.update(weights)
    hard_term = None
    if neg_ok is not None:
        ce, hard = descriptor_matching_loss_hard(desc1, desc2, pairs, pair_valid, neg_ok, valid2=valid2,
                                                 temperature=temperature, cross_image=cross_image,
                                                 hard_margin=hard_margin)
        desc_term, hard_term = guard(ce, 0.1), guard(hard, 0.0)
    else:
        desc_term = guard(descriptor_matching_loss(desc1, desc2, pairs, pair_valid, temperature), 0.1)
    comps = {
        "desc": desc_term,
        "variance": guard(descriptor_variance_loss(desc1, min_variance=min_variance), 0.0),
        "repeat": guard(repeatability_loss(saliency1, saliency2), 0.0),
        "peakiness": guard(peakiness_loss(saliency1, target_variance), 0.0),
        "activation": guard(activation_loss(saliency1, target_mean), 0.0),
        "edge": guard(edge_awareness_loss(saliency1, rgb1), 0.0),
        "sparsity": guard(spatial_sparsity_loss(saliency1, penalty_weight=sparsity_penalty), 0.0),
    }
    if hard_term is not None:
        comps["hard"] = hard_term
    total = sum(w.get(k, 0.0) * comps[k] for k in comps)
    return LossBundle(total=total, components=comps)
