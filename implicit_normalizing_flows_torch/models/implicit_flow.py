"""Multiscale implicit-flow image model, the CIFAR-10 recipe's path.

Counterpart of ``ImplicitFlow`` / ``StackedImplicitBlocks`` /
``build_conv_net`` (``models/implicit_flow.py:110-290, 499-529`` of the JAX
package) for ``factor_out=False``, ``fc_end=False``, ``first_resblock=True``:
per scale ``[init_layer?, actnorm?, n x (implicit block, actnorm?),
squeeze?]``, the channels growing 3 -> 12 -> 48 as the image shrinks
32x32 -> 16x16 -> 8x8. Module paths equal the JAX variables' paths
(``transforms.<scale>.<layer>...``). ``forward(..., train=True)`` runs the
training estimator and the implicit gradient; ``update_lipschitz`` is the
post-step power iteration. ``inverse(z)`` (``:535-559``, its
``factor_out=False`` branch) reshapes flat latents to ``dims[-1]`` (48 x 8
x 8 for the CIFAR-10 flagship) and runs the scales backwards: each block's
inverse is the fused solve with the nets' roles swapped
(``layers/implicit_block.py``), then the ActNorm, squeeze and
``LogitTransform`` inverses back to images in [0, 1].
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import (ActNorm2d, ImplicitBlock, InducedNormConv, LipschitzNet,
                      SequentialFlow, SqueezeLayer, Swish)


def build_conv_net(initial_size, idim, kernels, coeff, n_iterations, preact,
                   sn_atol, sn_rtol, first_resblock=True, generator=None,
                   device="cuda"):
    """``build_nnet`` (implicit_flow.py:362-399) with swish activations and
    (2, 2) induced norms: ``[swish] conv k0 · swish · conv k1 · swish · conv
    k2``, stride 1, same padding, built on ``device``."""
    c, h, w = initial_size
    ks = list(map(int, kernels.split("-")))
    conv = lambda cin, cout, k: InducedNormConv(
        cin, cout, k, (h, w), coeff=coeff, n_iterations=n_iterations,
        atol=sn_atol, rtol=sn_rtol, generator=generator, device=device)
    items = []
    if not first_resblock and preact:
        items.append(Swish(device))
    items += [conv(c, idim, ks[0]), Swish(device)]
    for k in ks[1:-1]:
        items += [conv(idim, idim, k), Swish(device)]
    items.append(conv(idim, c, ks[-1]))
    return LipschitzNet(items)


class StackedImplicitBlocks(SequentialFlow):
    """One scale of the stack (implicit_flow.py:157-277)."""

    def __init__(self, initial_size, idim, squeeze=True, init_layer=None,
                 n_blocks=1, actnorm=False, coeff=0.9, n_lipschitz_iters=None,
                 sn_atol=None, sn_rtol=None, n_dist="geometric", n_samples=1,
                 kernels="3-1-3", n_exact_terms=0, preact=False,
                 neumann_grad=True, grad_in_forward=False, first_resblock=True,
                 generator=None, device="cuda"):
        chain = []
        if init_layer is not None:
            chain.append(init_layer)
        if first_resblock and actnorm:
            chain.append(ActNorm2d(initial_size[0], device))
        for i in range(n_blocks):
            mk = lambda: build_conv_net(
                initial_size, idim, kernels, coeff, n_lipschitz_iters, preact,
                sn_atol, sn_rtol, first_resblock=first_resblock and i == 0,
                generator=generator, device=device)
            chain.append(ImplicitBlock(
                mk(), mk(), n_dist=n_dist, n_samples=n_samples,
                n_exact_terms=n_exact_terms, neumann_grad=neumann_grad,
                grad_in_forward=grad_in_forward, device=device))
            if actnorm:
                chain.append(ActNorm2d(initial_size[0], device))
        if squeeze:
            chain.append(SqueezeLayer(2))
        super().__init__(chain)


class ImplicitFlow(nn.Module):
    """Full multiscale model (implicit_flow.py:280-561) with its parameters
    and buffers on ``device`` (the card unless the caller asks for
    another)."""

    def __init__(self, input_size, n_blocks=(16, 16), intermediate_dim=64,
                 factor_out=False, init_layer=None, actnorm=False, coeff=0.9,
                 vnorms="2222", n_lipschitz_iters=None, sn_atol=None,
                 sn_rtol=None, n_dist="geometric", n_samples=1, kernels="3-1-3",
                 activation_fn="swish", fc_end=False, n_exact_terms=0,
                 preact=False, neumann_grad=True, grad_in_forward=False,
                 first_resblock=True, generator=None, device="cuda"):
        super().__init__()
        if factor_out or fc_end or not first_resblock:
            raise NotImplementedError(
                "ported: factor_out=False, fc_end=False, first_resblock=True")
        if activation_fn != "swish" or set(vnorms) != {"2"}:
            raise NotImplementedError("ported: swish nets with vnorms '2...2'")
        if len(vnorms) != len(kernels.split("-")) + 1:
            raise ValueError("vnorms must hold one more order than kernels")
        _, c, h, w = input_size
        n_scale, hh, ww = 0, h, w
        while hh >= 4 and ww >= 4:
            n_scale, hh, ww = n_scale + 1, hh // 2, ww // 2
        self.n_scale = min(len(n_blocks), n_scale)
        scales = []
        for i in range(self.n_scale):
            scales.append(StackedImplicitBlocks(
                (c, h, w), intermediate_dim, squeeze=i < self.n_scale - 1,
                init_layer=init_layer if i == 0 else None,
                n_blocks=n_blocks[i], actnorm=actnorm, coeff=coeff,
                n_lipschitz_iters=n_lipschitz_iters, sn_atol=sn_atol,
                sn_rtol=sn_rtol, n_dist=n_dist, n_samples=n_samples,
                kernels=kernels, n_exact_terms=n_exact_terms, preact=preact,
                neumann_grad=neumann_grad, grad_in_forward=grad_in_forward,
                first_resblock=i == 0, generator=generator, device=device))
            c, h, w = c * 4, h // 2, w // 2
        self.transforms = nn.ModuleList(scales)
        # the output shapes (calc_output_size, implicit_flow.py:372, 387-391):
        # one, the last scale's, without factor_out
        k = self.n_scale - 1
        self.dims = [(input_size[1] * 4 ** k, input_size[2] // 2 ** k, input_size[3] // 2 ** k)]

    def forward(self, x, logpx=None, draws=None, train=False):
        """(z flattened to (B, D), logpz)."""
        for t in self.transforms:
            x, logpx = t(x, logpx, draws, train=train)
        return x.reshape(x.shape[0], -1), logpx

    @torch.no_grad()
    def inverse(self, z, logpz=None, draws=None):
        """(x, logpx): latents z (B, D) or (B, *dims[-1]) back to inputs,
        the scales in reverse (``implicit_flow.py:553-559``), without
        gradient (the blocks' solves stop it, as in the JAX package)."""
        z = z.reshape((z.shape[0],) + tuple(self.dims[-1]))
        for t in reversed(self.transforms):
            z, logpz = t.inverse(z, logpz, draws)
        return z, logpz

    def implicit_blocks(self):
        return [m for m in self.modules() if isinstance(m, ImplicitBlock)]

    @torch.no_grad()
    def update_lipschitz(self, n_iterations=None):
        """Post-step power iteration of every implicit block's convs
        (``implicit_flow.py:564-575``): the blocks' own budget (adaptive
        atol/rtol when None)."""
        for block in self.implicit_blocks():
            block.update_lipschitz(n_iterations)
