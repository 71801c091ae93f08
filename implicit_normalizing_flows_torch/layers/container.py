"""``SequentialFlow`` (``layers/container.py:10-66`` of the JAX package):
children are named "0", "1", ... like the JAX variables list. Inputs of
any rank pass through: (B, c, H, W) images or (B, D) tabular rows."""
from __future__ import annotations

import torch
from torch import nn

from .implicit_block import ImplicitBlock
from .lipschitz import InducedNormConv, InducedNormDense, update_dense_lipschitz


class SequentialFlow(nn.ModuleList):
    def forward(self, x, logpx=None, draws=None, train=False):
        for layer in self:
            x, logpx = layer(x, logpx, draws, train=train)
        return x, logpx

    def inverse(self, y, logpy=None, draws=None):
        """The children's inverses in reverse order (``container.py:62-66``)."""
        for layer in reversed(self):
            y, logpy = layer.inverse(y, logpy, draws)
        return y, logpy

    def implicit_blocks(self):
        return [m for m in self.modules() if isinstance(m, ImplicitBlock)]

    @torch.no_grad()
    def update_lipschitz(self, n_iterations=None):
        """Post-step power iteration of every soft-normalised layer of the
        blocks' nets, the dense ones of all blocks together
        (:func:`update_dense_lipschitz`)."""
        update_dense_lipschitz([m for m in self.modules() if isinstance(m, InducedNormDense)],
                               n_iterations)
        for m in self.modules():
            if isinstance(m, InducedNormConv):
                m.update_lipschitz(n_iterations)
