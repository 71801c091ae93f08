"""Exponential moving average of the parameters (``training/ema.py`` of the
JAX package; decay 0.999 as the reference's ``utils.py:128``)."""
from __future__ import annotations

import torch


def ema_init(params) -> dict:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_apply(shadow, params, decay=0.999) -> None:
    """shadow -= (1 - decay) * (shadow - params), in place (``ema.py:13-16``),
    one multi-tensor call per operation."""
    keys = list(shadow)
    ss = [shadow[k] for k in keys]
    torch._foreach_sub_(ss, torch._foreach_mul(
        torch._foreach_sub(ss, [params[k] for k in keys]), 1.0 - decay))
