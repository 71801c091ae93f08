"""The soft-normalised layers of the residual nets: ``InducedNormConv``
(the CIFAR recipe) and ``InducedNormDense`` (the tabular and toy recipes).

Counterparts of ``InducedNormConv`` (``layers/lipschitz.py:163-280`` of the
JAX package) and ``InducedNormDense`` (``:77-160``) for (domain, codomain) =
(2, 2), which ``get_conv`` / ``get_dense`` route to them
(``lipschitz.py:502-525``). The weight applied is ``w / max(1, sigma /
coeff)`` with ``sigma = <u, W v>`` from the power-iteration buffers
``u``/``v``; gradients reach ``w`` through sigma with ``u``/``v`` constant
(``lipschitz.py:127-133, 241-250``). Other norms are not ported (raise).

Both layers apply a given effective weight and bias with ``apply_with``,
which the generic implicit-gradient path uses to run a net on tensors it
differentiates itself (``LipschitzNet.lipschitz_tensors``).

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

    def apply_with(self, w, b, x):
        return pi.conv_apply(w, x, self.padding) + b[None, :, None, None]

    def forward(self, x):
        """In ``x``'s dtype (see the module note)."""
        return self.apply_with(self.effective_weight(x.dtype), self.bias.to(x.dtype), x)

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


class InducedNormDense(nn.Module):
    """``x @ W.T + b`` with ``W`` soft-normalised to ``coeff`` in the (2, 2)
    induced norm (``InducedNormDense``, ``lipschitz.py:77-160``). At
    construction ``u``/``v`` settle over 200 power iterations, as the JAX
    ``init`` does; ``zero_init`` divides the initial weight by 1000 (the
    layer projecting back to the data, ``mixed_lipschitz.py:60-62``)."""

    def __init__(self, in_features, out_features, coeff=0.97, domain=2.0, codomain=2.0,
                 n_iterations=None, atol=None, rtol=None, zero_init=False, learn_p=False,
                 generator=None, device=None):
        super().__init__()
        if learn_p:
            raise NotImplementedError("learned p-orders are not ported")
        if (domain, codomain) != (2, 2):
            raise NotImplementedError(
                f"induced norm ({domain}, {codomain}): only (2, 2) is ported")
        self.in_features, self.out_features = in_features, out_features
        self.coeff = coeff
        self.n_iterations, self.atol, self.rtol = n_iterations, atol, rtol
        # kaiming_uniform(a=sqrt(5)) as the JAX package draws it; drawn and
        # settled on the generator's device, then moved
        bound = 1.0 / math.sqrt(in_features)
        gdev = generator.device if generator is not None else None
        u01 = lambda *s: torch.rand(*s, generator=generator, device=gdev)
        w = (u01(out_features, in_features) * 2 - 1) * bound
        if zero_init:
            w = w / 1000.0
        b = (u01(out_features) * 2 - 1) * bound
        normal = lambda n: torch.randn(n, generator=generator, device=gdev)
        u, v = pi.induced_norm_dense(w, pi.l2_normalize(normal(out_features)),
                                     pi.l2_normalize(normal(in_features)), n_iterations=200)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(b.to(device))
        self.register_buffer("u", u.to(device))
        self.register_buffer("v", v.to(device))
        self.register_buffer("sigma", pi.dense_sigma(w, u, v).to(device))

    def effective_weight(self, dtype=None):
        w = self.weight if dtype is None else self.weight.to(dtype)
        sigma = pi.dense_sigma(w, self.u.to(w.dtype), self.v.to(w.dtype))
        return w / torch.clamp(sigma / self.coeff, min=1.0)

    def apply_with(self, w, b, x):
        return x @ w.T + b

    def forward(self, x):
        """In ``x``'s dtype: the weight, bias and buffers are cast first."""
        return self.apply_with(self.effective_weight(x.dtype), self.bias.to(x.dtype), x)

    def update_lipschitz(self, n_iterations=None):
        update_dense_lipschitz([self], n_iterations)


@torch.no_grad()
def update_dense_lipschitz(layers, n_iterations=None):
    """The post-step power iteration of :class:`InducedNormDense` layers
    (``n_iterations`` overrides each layer's budget), those of one shape and
    budget run together by ``power_iter.induced_norm_dense_stack``:
    a model's hundreds of small layers in a few host loops. Each layer's
    iterates and stop are its own, as if it ran alone."""
    groups = {}
    for layer in layers:
        n = n_iterations if n_iterations is not None else layer.n_iterations
        key = (tuple(layer.weight.shape), n, layer.atol, layer.rtol)
        groups.setdefault(key, []).append(layer)
    for (_, n, atol, rtol), group in groups.items():
        w = torch.stack([layer.weight for layer in group])
        u, v = pi.induced_norm_dense_stack(
            w, torch.stack([layer.u for layer in group]),
            torch.stack([layer.v for layer in group]), n_iterations=n, atol=atol, rtol=rtol)
        sigma = torch.sum(u * torch.bmm(w, v[:, :, None])[:, :, 0], dim=1)
        for name, value in (("u", u), ("v", v), ("sigma", sigma)):
            torch._foreach_copy_([getattr(layer, name) for layer in group], list(value))


def get_dense(in_features, out_features, bias=True, coeff=0.97, domain=None,
              codomain=None, **kwargs):
    """``get_dense`` (``lipschitz.py:502-513``) for the (2, 2) norms, which it
    routes to :class:`InducedNormDense` (the other pairs raise there); the
    layers have a bias, as every net the builders make."""
    if not bias:
        raise NotImplementedError("dense layers without bias are not ported")
    return InducedNormDense(in_features, out_features, coeff=coeff, domain=domain,
                            codomain=codomain, **kwargs)
