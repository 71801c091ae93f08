"""Residual conv nets inside the implicit blocks.

Counterpart of ``LipschitzNet`` (``layers/nets.py:42-227`` of the JAX
package) for the recipe stack ``[swish] conv3x3 · swish · conv1x1 · swish ·
conv3x3``. ``conv_forward_data`` is the contract the fused solve consumes.
"""
from __future__ import annotations

import torch
from torch import nn

from .activations import Swish
from .lipschitz import InducedNormConv


class LipschitzNet(nn.Module):
    def __init__(self, items):
        super().__init__()
        self.layers = nn.ModuleList(items)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def conv_forward_data(self):
        """Effective kernels ``w1/w2/w3``, biases ``b1/b2/b3``, swish slopes
        ``betas`` = (beta0, beta1, beta2) (beta0 = 1 when not preact) and the
        ``preact`` flag, or None when the stack is not the recipe's."""
        items = list(self.layers)
        pattern = "".join("a" if isinstance(it, Swish)
                          else "c" if isinstance(it, InducedNormConv) else "?"
                          for it in items)
        if pattern not in ("cacac", "acacac"):
            return None
        preact = pattern == "acacac"
        convs = [it for it in items if isinstance(it, InducedNormConv)]
        acts = [it for it in items if isinstance(it, Swish)]
        if [cv.kernel_size for cv in convs] != [(3, 3), (1, 1), (3, 3)]:
            return None
        one = torch.ones((), device=convs[0].weight.device)
        betas = [acts[0].slope() if preact else one,
                 acts[-2].slope(), acts[-1].slope()]
        return dict(
            w1=convs[0].effective_weight(), w2=convs[1].effective_weight(),
            w3=convs[2].effective_weight(),
            b1=convs[0].bias, b2=convs[1].bias, b3=convs[2].bias,
            betas=torch.stack(betas), preact=preact)

    def update_lipschitz(self, n_iterations=None):
        for layer in self.layers:
            if isinstance(layer, InducedNormConv):
                layer.update_lipschitz(n_iterations)
