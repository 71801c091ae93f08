"""Activations of the residual nets (``layers/activations.py`` of the JAX
package): swish with a learnable slope (``:108-117``), ``x * sigmoid(x *
softplus(beta)) / 1.1``, and the tabular and toy recipes' ``sin``
(``:39-43``), ``sin(2 pi x) / (2 pi)``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Swish(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.beta = nn.Parameter(torch.full((1,), 0.5, device=device))

    def slope(self, dtype=None):
        """softplus(beta) as a 0-d tensor, computed in ``dtype`` (default
        the parameter's) from the cast parameter, as the JAX package does
        under its bfloat16 casts."""
        beta = self.beta if dtype is None else self.beta.to(dtype)
        return F.softplus(beta).reshape(())

    def forward(self, x):
        """In ``x``'s dtype: a bfloat16 input runs the whole activation in
        bfloat16 (the training estimator's casts)."""
        return x * torch.sigmoid(x * self.slope(x.dtype)) / 1.1


class Sin(nn.Module):
    """``sin(2 pi x) / (2 pi)``, 1-Lipschitz, in ``x``'s dtype."""

    def forward(self, x):
        return torch.sin(2.0 * math.pi * x) / math.pi * 0.5
