"""Adam with the reference's update semantics, global-norm clipping and a
learning-rate schedule, over a ``{name: tensor}`` dict of parameters.

Counterpart of ``adam`` = ``_with_common(scale_by_torch_adam(...))`` of the
JAX package (``training/optimizers.py:32-55,110-127``), in the order of its
optax chain:

1. clip by global norm (``optax.clip_by_global_norm``): ``g`` unchanged
   when ``norm < max_norm``, else ``g / norm * max_norm``;
2. torch-semantics Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
   g^2``, ``step = -sqrt(bc2) / bc1 * m / (sqrt(v) + eps)`` with the bias
   corrections in float32;
3. optional decoupled weight decay ``step -= wd * p``;
4. ``p += lr(count) * step`` with the schedule's own step count from 0.

``torch.optim.Adam`` and ``clip_grad_norm_`` round differently (eps added to
``sqrt(v) / sqrt(bc2)``; division by ``norm + 1e-6``), so they are not used.
A missing gradient counts as zeros, as JAX's are for parameters the loss
does not reach.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


@dataclass
class AdamState:
    count: int = 0
    mu: dict = field(default_factory=dict)
    nu: dict = field(default_factory=dict)


class Adam:
    def __init__(self, lr_schedule, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, grad_clip=None):
        self.lr_schedule = lr_schedule
        self.b1, self.b2 = betas
        self.eps, self.weight_decay, self.grad_clip = eps, weight_decay, grad_clip

    def init(self, params) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> AdamState:
        """Apply one step to ``params`` in place; returns the new state."""
        grads = {k: (grads.get(k) if grads.get(k) is not None
                     else torch.zeros_like(p)) for k, p in params.items()}
        if self.grad_clip is not None:
            norm = global_norm(grads)
            if not bool(norm < self.grad_clip):
                grads = {k: g / norm * self.grad_clip for k, g in grads.items()}
        count = state.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1 = 1 - f32(self.b1) ** f32(count)
        bc2 = 1 - f32(self.b2) ** f32(count)
        scale = float(torch.sqrt(bc2) / bc1)  # exact: a float32 value
        lr = float(self.lr_schedule(state.count))
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = self.b1 * state.mu[k] + (1 - self.b1) * g
            nu[k] = self.b2 * state.nu[k] + (1 - self.b2) * g * g
            step = -scale * mu[k] / (torch.sqrt(nu[k]) + self.eps)
            if self.weight_decay:
                step = step - self.weight_decay * p
            p.add_(lr * step)
        return AdamState(count, mu, nu)


def adam(lr_schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         grad_clip=None) -> Adam:
    return Adam(lr_schedule, betas, eps, weight_decay, grad_clip)
