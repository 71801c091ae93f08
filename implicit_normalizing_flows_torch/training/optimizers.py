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
    """sqrt of the sum of squares of every gradient (``optax.global_norm``),
    from the per-tensor norms of one multi-tensor call."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads.values()))))


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
        keys = list(params)
        ps = [params[k] for k in keys]
        gs = [grads.get(k) if grads.get(k) is not None else torch.zeros_like(params[k])
              for k in keys]
        if self.grad_clip is not None:
            norm = global_norm(dict(zip(keys, gs)))
            if not bool(norm < self.grad_clip):
                gs = torch._foreach_mul(torch._foreach_div(gs, norm), self.grad_clip)
        count = state.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1 = 1 - f32(self.b1) ** f32(count)
        bc2 = 1 - f32(self.b2) ** f32(count)
        scale = float(torch.sqrt(bc2) / bc1)  # exact: a float32 value
        lr = float(self.lr_schedule(state.count))
        # the formulas of the module note, one multi-tensor call per
        # elementwise operation in their order (the same float32 roundings)
        add, mul = torch._foreach_add, torch._foreach_mul
        mu = add(mul([state.mu[k] for k in keys], self.b1), mul(gs, 1 - self.b1))
        nu = add(mul([state.nu[k] for k in keys], self.b2), mul(mul(gs, 1 - self.b2), gs))
        step = torch._foreach_div(mul(mu, -scale), add(torch._foreach_sqrt(nu), self.eps))
        if self.weight_decay:
            step = torch._foreach_sub(step, mul(ps, self.weight_decay))
        torch._foreach_add_(ps, mul(step, lr))
        return AdamState(count, dict(zip(keys, mu)), dict(zip(keys, nu)))


def adam(lr_schedule, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
         grad_clip=None) -> Adam:
    return Adam(lr_schedule, betas, eps, weight_decay, grad_clip)
