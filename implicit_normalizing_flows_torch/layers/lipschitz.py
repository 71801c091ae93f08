"""``InducedNormConv``: the soft-normalised conv of the CIFAR recipe.

Counterpart of ``layers/lipschitz.py:163-280`` of the JAX package for
(domain, codomain) = (2, 2), which ``get_conv`` routes to InducedNormConv
(``lipschitz.py:515-525``). The kernel convolved is
``w / max(1, sigma / coeff)`` with ``sigma = <u, conv(v)>`` from the
power-iteration buffers ``u``/``v``; gradients reach ``w`` through sigma
with ``u``/``v`` constant (``lipschitz.py:241-250``).

Every computation runs in the dtype asked for (default float32): the
weight, bias and buffers are cast first, as the JAX package casts its
whole variable tree to bfloat16 for the training estimator and the
backward solve's linearisation.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import power_iter as pi


class InducedNormConv(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, input_hw,
                 coeff=0.97, n_iterations=None, atol=None, rtol=None,
                 generator=None, device=None):
        super().__init__()
        k = kernel_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = (k, k)
        self.padding = k // 2
        self.coeff = coeff
        self.n_iterations, self.atol, self.rtol = n_iterations, atol, rtol
        h, w = input_hw
        self.x_shape = (1, in_channels, h, w)
        self.out_shape = (1, out_channels, h, w)
        self.is_1x1 = k == 1
        # torch's conv default init == the JAX package's kaiming_uniform
        # (a=sqrt(5)): U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for weight and bias.
        # Drawn on the generator's device, so a seed gives the same weights
        # on every device.
        bound = 1.0 / math.sqrt(in_channels * k * k)
        gdev = generator.device if generator is not None else None
        u01 = lambda *s: torch.rand(*s, generator=generator, device=gdev).to(device)
        normal = lambda n: torch.randn(n, generator=generator, device=gdev).to(device)
        self.weight = nn.Parameter((u01(out_channels, in_channels, k, k) * 2 - 1) * bound)
        self.bias = nn.Parameter((u01(out_channels) * 2 - 1) * bound)
        nu, nv = ((out_channels, in_channels) if self.is_1x1 else
                  (out_channels * h * w, in_channels * h * w))
        self.register_buffer("u", pi.l2_normalize(normal(nu)))
        self.register_buffer("v", pi.l2_normalize(normal(nv)))
        self.register_buffer("sigma", torch.zeros((), device=device))

    def _sigma(self, w):
        u, v = self.u.to(w.dtype), self.v.to(w.dtype)
        if self.is_1x1:
            return pi.dense_sigma(w.reshape(self.out_channels, self.in_channels), u, v)
        return pi.conv_sigma(w, u, v, self.x_shape, self.padding)

    def effective_weight(self, dtype=None):
        w = self.weight if dtype is None else self.weight.to(dtype)
        return w / torch.clamp(self._sigma(w) / self.coeff, min=1.0)

    def forward(self, x):
        """In ``x``'s dtype (see the module note)."""
        y = pi.conv_apply(self.effective_weight(x.dtype), x, self.padding)
        return y + self.bias.to(x.dtype)[None, :, None, None]

    @torch.no_grad()
    def update_lipschitz(self, n_iterations=None):
        n = n_iterations if n_iterations is not None else self.n_iterations
        w = self.weight
        if self.is_1x1:
            u, v = pi.induced_norm_dense(
                w.reshape(self.out_channels, self.in_channels), self.u, self.v,
                n_iterations=n, atol=self.atol, rtol=self.rtol)
        else:
            u, v = pi.induced_norm_conv(
                w, self.u, self.v, self.x_shape, self.out_shape, self.padding,
                n_iterations=n, atol=self.atol, rtol=self.rtol)
        self.u.copy_(u)
        self.v.copy_(v)
        self.sigma.copy_(self._sigma(w))
