"""Swish with a learnable slope (``layers/activations.py:108-117`` of the
JAX package): ``x * sigmoid(x * softplus(beta)) / 1.1``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Swish(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.beta = nn.Parameter(torch.full((1,), 0.5, device=device))

    def slope(self):
        """softplus(beta) as a 0-d tensor."""
        return F.softplus(self.beta).reshape(())

    def forward(self, x):
        return x * torch.sigmoid(x * F.softplus(self.beta)) / 1.1
