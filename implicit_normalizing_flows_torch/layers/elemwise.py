"""``LogitTransform`` (``layers/elemwise.py:51-74`` of the JAX package):
``y = logit(alpha + (1 - 2 alpha) x)``, and its inverse ``x = (sigmoid(y) -
alpha) / (1 - 2 alpha)``."""
from __future__ import annotations

import math

import torch

from .protocol import Flow


class LogitTransform(Flow):
    def __init__(self, alpha=1e-6):
        super().__init__()
        self.alpha = alpha

    def _logdetgrad(self, x):
        s = self.alpha + (1 - 2 * self.alpha) * x
        per_elem = -torch.log(s - s * s) + math.log(1 - 2 * self.alpha)
        return per_elem.reshape(x.shape[0], -1).sum(1)

    def forward(self, x, logpx=None, draws=None, train=False):
        s = self.alpha + (1 - 2 * self.alpha) * x
        y = torch.log(s) - torch.log(1 - s)
        if logpx is None:
            return y, None
        return y, logpx - self._logdetgrad(x)

    def inverse(self, y, logpy=None, draws=None):
        x = (torch.sigmoid(y) - self.alpha) / (1 - 2 * self.alpha)
        if logpy is None:
            return x, None
        return x, logpy + self._logdetgrad(x)
