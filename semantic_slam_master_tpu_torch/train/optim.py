"""The trainers' optimisers, written out in plain tensor code: optax's

- ``chain(clip_by_global_norm(c), adamw(warmup_cosine_decay_schedule(...),
  weight_decay))`` of the frontend trainer (``train/trainer.py``'s
  ``build_optimizer``), and
- ``adamw(cosine_decay_schedule(lr, n), 1e-4)`` of the segmenter trainer
  (``train/seg_trainer.py``),

step for step as optax 0.2 computes them:

- clipping scales every gradient by c / ||g|| only when ||g|| >= c (one
  global norm over all trainable leaves; no epsilon);
- Adam's moments ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``,
  bias-corrected with ``count + 1``, ``eps`` outside the square root
  (``eps_root`` 0);
- decoupled weight decay ``+ wd * p`` on every trainable leaf, biases and
  norms included;
- the update ``-lr(count) * (...)`` with the learning rate read at the
  schedule's own count *before* it moves, so a warm-up from 0 leaves the
  parameters of a fresh run's first step where they were (the moments
  still move).

``scale_by_adam`` and the schedule keep one count each; both start at 0,
and a step the trainer skips moves neither. The schedules are evaluated
in float32, as optax evaluates them under ``jit``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
f32 = np.float32


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], np.float32]:
    """optax's: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> np.float32:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], np.float32]:
    """optax's: ``init_value * ((1 - alpha) * 0.5 (1 + cos(pi t / T)) + alpha)``
    with t clipped at T."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        t = f32(min(float(count), float(decay_steps)))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps), dtype=f32))
        return f32(init_value) * (f32(1 - alpha) * cos + f32(alpha))

    return schedule


@dataclass
class AdamWState:
    """Adam's moments by parameter name and the two counts."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    adam_count: int = 0
    schedule_count: int = 0


@dataclass
class AdamW:
    """``[clip_by_global_norm(grad_clip)] + adamw(schedule, weight_decay)``
    over dicts of tensors keyed by parameter name; ``order`` is the leaf
    order of the global norm's sum (the flax tree's)."""

    schedule: Callable[[int], np.float32]
    weight_decay: float
    grad_clip: float | None = None
    order: list = field(default_factory=list)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(mu={k: torch.zeros_like(p) for k, p in params.items()},
                          nu={k: torch.zeros_like(p) for k, p in params.items()})

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        keys = self.order or list(grads)
        total = 0
        for k in keys:
            total = total + torch.sum(grads[k] * grads[k])
        return torch.sqrt(total)

    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState, params: Dict[str, torch.Tensor]):
        """(new params, new state, global gradient norm): new tensors; the
        inputs are left as they were, so a skipped step keeps them."""
        g_norm = self.global_norm(grads)
        if self.grad_clip is not None and not bool(g_norm < self.grad_clip):
            grads = {k: (g / g_norm) * self.grad_clip for k, g in grads.items()}
        count = state.adam_count + 1
        dev = g_norm.device
        bc1 = torch.tensor(1 - f32(B1) ** f32(count), dtype=torch.float32, device=dev)
        bc2 = torch.tensor(1 - f32(B2) ** f32(count), dtype=torch.float32, device=dev)
        step_size = torch.tensor(-self.schedule(state.schedule_count), dtype=torch.float32, device=dev)
        new_params, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - B1) * g + B1 * state.mu[k]
            nu[k] = (1 - B2) * (g * g) + B2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
            u = u + self.weight_decay * params[k]
            new_params[k] = params[k] + step_size * u
        return new_params, AdamWState(mu, nu, count, state.schedule_count + 1), g_norm
