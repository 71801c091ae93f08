"""Residual nets inside the implicit blocks.

Counterpart of ``LipschitzNet`` (``layers/nets.py:42-227`` of the JAX
package): an ordered stack of soft-normalised layers and activations. For
the recipe conv stack ``[swish] conv3x3 · swish · conv1x1 · swish · conv3x3``
``conv_forward_data`` is the contract the fused solve and the re-attachment
VJP consume, ``conv_chain_data`` the one of the backward solve; for any
other stack (the tabular and toy MLPs) both are None and the implicit block
takes the generic solver path, which runs the net on its effective tensors
(``lipschitz_tensors`` / ``apply_tensors``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_solve import dswish
from .activations import Swish
from .lipschitz import InducedNormConv, InducedNormDense


class LipschitzNet(nn.Module):
    def __init__(self, items):
        super().__init__()
        self.layers = nn.ModuleList(items)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def _recipe(self):
        """(convs, acts, preact) of the recipe stack, or None."""
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
        return convs, acts, preact

    def conv_forward_data(self):
        """Effective kernels ``w1/w2/w3``, biases ``b1/b2/b3``, swish slopes
        ``betas`` = (beta0, beta1, beta2) (beta0 = 1 when not preact) and the
        ``preact`` flag, or None when the stack is not the recipe's.
        Differentiable w.r.t. the raw parameters."""
        recipe = self._recipe()
        if recipe is None:
            return None
        convs, acts, preact = recipe
        one = torch.ones((), device=convs[0].weight.device)
        betas = [acts[0].slope() if preact else one,
                 acts[-2].slope(), acts[-1].slope()]
        return dict(
            w1=convs[0].effective_weight(), w2=convs[1].effective_weight(),
            w3=convs[2].effective_weight(),
            b1=convs[0].bias, b2=convs[1].bias, b3=convs[2].bias,
            betas=torch.stack(betas), preact=preact)

    @torch.no_grad()
    def conv_chain_data(self, x, dtype=torch.float32):
        """Linearisation data at ``x`` (``conv_chain_data``,
        ``nets.py:105-165`` of the JAX package): ``(s0, s1, s2, w1, w2,
        w3)``, the swish derivatives at the pre-activations (s0 = ones
        without preact) and the effective kernels, all in ``dtype``. The
        whole net runs in ``dtype`` from cast parameters and buffers, as the
        JAX backward solve runs it under its bfloat16 casts; the derivatives
        are :func:`dswish` rounded to ``dtype``."""
        recipe = self._recipe()
        if recipe is None:
            return None
        convs, acts, preact = recipe
        w1, w2, w3 = (cv.effective_weight(dtype) for cv in convs)
        b1, b2 = (cv.bias.to(dtype)[None, :, None, None] for cv in convs[:2])
        h = x.to(dtype)
        if preact:
            s0 = dswish(h, acts[0].slope(dtype)).to(dtype)
            h = acts[0](h)
        else:
            s0 = torch.ones_like(h)
        h1 = F.conv2d(h, w1, padding=1) + b1
        s1 = dswish(h1, acts[-2].slope(dtype)).to(dtype)
        h2 = F.conv2d(acts[-2](h1), w2) + b2
        s2 = dswish(h2, acts[-1].slope(dtype)).to(dtype)
        return s0, s1, s2, w1, w2, w3

    def _lipschitz_layers(self):
        return [it for it in self.layers if isinstance(it, (InducedNormConv, InducedNormDense))]

    def lipschitz_tensors(self, dtype=None):
        """Every soft-normalised layer's effective weight and bias, in
        order, in ``dtype`` (default the parameters'), differentiable w.r.t.
        the raw parameters."""
        out = []
        for layer in self._lipschitz_layers():
            out += [layer.effective_weight(dtype),
                    layer.bias if dtype is None else layer.bias.to(dtype)]
        return out

    def apply_tensors(self, tensors, x):
        """The net on ``x`` with the soft-normalised layers' effective
        weights and biases taken from ``tensors`` (``lipschitz_tensors``'
        order)."""
        it = iter(tensors)
        for layer in self.layers:
            x = (layer.apply_with(next(it), next(it), x)
                 if isinstance(layer, (InducedNormConv, InducedNormDense)) else layer(x))
        return x

    def update_lipschitz(self, n_iterations=None):
        for layer in self._lipschitz_layers():
            layer.update_lipschitz(n_iterations)
