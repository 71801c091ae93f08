"""Exponential moving average of the parameters (``training/ema.py`` of the
JAX package; decay 0.999 as the reference's ``utils.py:128``)."""
from __future__ import annotations

import torch


def ema_init(params) -> dict:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_apply(shadow, params, decay=0.999) -> None:
    """shadow -= (1 - decay) * (shadow - params), in place (``ema.py:13-16``)."""
    for k, s in shadow.items():
        s.sub_((1.0 - decay) * (s - params[k]))
