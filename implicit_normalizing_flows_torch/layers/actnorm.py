"""``ActNorm2d`` forward (``layers/actnorm.py`` of the JAX package):
``y = (x + bias) * exp(weight)`` per channel, differentiable in both. The
data-dependent init pass is not ported (training starts from a
checkpoint)."""
from __future__ import annotations

import torch
from torch import nn

from .protocol import Flow


class ActNorm2d(Flow):
    def __init__(self, num_features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x, logpx=None, draws=None, train=False):
        y = (x + self.bias[None, :, None, None]) * torch.exp(self.weight[None, :, None, None])
        if logpx is None:
            return y, None
        n_per_channel = x.numel() // (x.shape[0] * x.shape[1])
        return y, logpx - self.weight.sum() * n_per_channel
