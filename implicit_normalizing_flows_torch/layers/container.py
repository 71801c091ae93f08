"""``SequentialFlow`` (``layers/container.py:10-60`` of the JAX package):
children are named "0", "1", ... like the JAX variables list."""
from __future__ import annotations

from torch import nn


class SequentialFlow(nn.ModuleList):
    def forward(self, x, logpx=None, draws=None, train=False):
        for layer in self:
            x, logpx = layer(x, logpx, draws, train=train)
        return x, logpx
