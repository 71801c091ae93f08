"""``ActNorm2d`` (``layers/actnorm.py`` of the JAX package): ``y = (x +
bias) * exp(weight)`` per channel, differentiable in both, and its inverse
``x = y * exp(-weight) - bias`` (``:61-68``). The
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
        return y, logpx - self._logdetgrad(x)

    def _logdetgrad(self, x):
        """weight summed over every non-batch entry (``actnorm.py:49-52``)."""
        return self.weight.sum() * (x.numel() // (x.shape[0] * x.shape[1]))

    def inverse(self, y, logpy=None, draws=None):
        x = y * torch.exp(-self.weight[None, :, None, None]) - self.bias[None, :, None, None]
        if logpy is None:
            return x, None
        return x, logpy + self._logdetgrad(x)
