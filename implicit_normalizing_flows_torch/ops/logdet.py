"""Log-determinant estimation of the evaluation and training paths.

Counterpart of ``ops/logdet.py`` of the JAX package: Rademacher probes, the
Russian-roulette truncation with its coefficients (``logdet.py:65-135``),
the **basic** power-series estimator (``logdet.py:278-297``): ``sum_k
(-1)^(k+1)/k * coeff(k) * <eps, J^k eps>`` via repeated autograd
vector-Jacobian products, of evaluation and, differentiable, of the
tabular training path (``neumann_grad=False``); the **Neumann** gradient
estimator of image training (``logdet.py:145-185``,
:func:`residual_logdet`), and both nets' stop-gradient Neumann
accumulations of the ``--mem-eff False`` path through the fused chain
kernels (:func:`neumann_pair_accs`, ``logdet.py:215-251``) and the
differentiable term that closes an accumulation (:func:`neumann_final`,
the merged path's, ``logdet.py:259-275``); the exact
brute-force log-det of small flat inputs (:func:`brute_force_logdet`,
``logdet.py:300-337``). The series stops at ``n_power``: the coefficients
beyond it are exactly 0.

Every random draw comes from a :class:`Draws`, which either samples from a
``torch.Generator`` or replays numbers handed to it (the tests replay the
JAX package's own draws).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import kernel_config
from . import fused_chain


class Draws:
    """Source of the evaluation path's random numbers.

    ``Draws(generator)`` samples; ``Draws(replay={...})`` hands out recorded
    arrays in order, per kind: ``'uniform'`` (dequantisation noise),
    ``'rademacher'`` (probes, ±1) and ``'roulette'`` (truncation draws)."""

    def __init__(self, generator: torch.Generator | None = None, replay=None):
        self.generator = generator
        self.replay = ({k: list(v) for k, v in replay.items()}
                       if replay is not None else None)

    def _recorded(self, kind, shape, device, dtype):
        t = torch.as_tensor(np.array(self.replay[kind].pop(0))).to(device=device, dtype=dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed {kind} draw has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        return t

    def _gen_device(self, device):
        gd = self.generator.device if self.generator is not None else None
        return device if gd is None or gd.type == torch.device(device).type else gd

    def uniform(self, shape, device):
        if self.replay is not None:
            return self._recorded("uniform", shape, device, torch.float32)
        return torch.rand(shape, generator=self.generator,
                          device=self._gen_device(device)).to(device)

    def rademacher(self, shape, device):
        if self.replay is not None:
            return self._recorded("rademacher", shape, device, torch.float32)
        bits = torch.randint(0, 2, shape, generator=self.generator,
                             device=self._gen_device(device)).to(device)
        return bits.float() * 2 - 1

    def roulette(self, n_dist, n, geom_p, lamb, device):
        """(n,) int64 truncation draws: Poisson(lamb) or Geometric(p) on
        {1, 2, ...} (numpy's ``geometric``)."""
        if self.replay is not None:
            return self._recorded("roulette", (n,), device, torch.int64)
        dev = self._gen_device(device)
        if n_dist == "poisson":
            rate = torch.full((n,), float(lamb), device=dev)
            return torch.poisson(rate, generator=self.generator).long().to(device)
        if n_dist == "geometric":
            tiny = torch.finfo(torch.float32).tiny
            u = torch.rand((n,), generator=self.generator, device=dev) * (1 - tiny) + tiny
            k = torch.floor(torch.log(u) / math.log1p(-float(geom_p))) + 1
            return torch.clamp(k, min=1).long().to(device)
        raise ValueError(f"unknown n_dist {n_dist}")


def geometric_1mcdf(p, k, offset):
    """P(n >= k - offset), 1 for k <= offset (implicit_block.py:461-467)."""
    kk = torch.clamp(k - offset, min=1)
    return torch.where(k <= offset, torch.ones((), device=k.device),
                       (1.0 - p) ** torch.clamp(kk - 1, min=0).float())


def poisson_1mcdf(lamb, k, offset, max_k):
    """P(n >= k - offset) for Poisson (implicit_block.py:470-483), as the
    JAX package's vectorised cumulative sum up to ``max_k``."""
    i = torch.arange(0, max_k + 1, dtype=torch.float32, device=k.device)
    lamb = torch.as_tensor(lamb, dtype=torch.float32, device=k.device)
    log_terms = i * torch.log(torch.clamp(lamb, min=1e-20)) - torch.lgamma(i + 1.0)
    cum = torch.cumsum(torch.exp(log_terms), 0)
    kk = torch.clamp(k - offset, 1, max_k + 1)
    s = cum[torch.clamp(kk - 1, max=max_k)]
    return torch.where(k <= offset, torch.ones((), device=k.device),
                       1.0 - torch.exp(-lamb) * s)


def sample_n_dist(draws: Draws, n_dist, n_samples, geom_p, lamb, offset,
                  series_cap, device):
    """Roulette coefficients (``sample_n_dist``, ``logdet.py:97-135``): the
    caller passes ``offset`` = ``n_exact_terms_test`` in evaluation and
    ``n_exact_terms`` in training.

    Returns ``(coeffs, n_power, n_draws)``: ``coeffs`` has length
    ``offset + series_cap`` with ``coeffs[k-1]`` multiplying term k and
    zero beyond ``n_power = max(n_draws) + offset`` (a host int)."""
    cap = offset + series_cap
    n_draws = torch.clamp(draws.roulette(n_dist, n_samples, geom_p, lamb, device),
                          max=series_cap)
    n_power = int(n_draws.max().item()) + offset
    ks = torch.arange(1, cap + 1, device=device)
    geom_p = torch.as_tensor(geom_p, dtype=torch.float32, device=device)
    if n_dist == "geometric":
        rcdf = geometric_1mcdf(geom_p, ks, offset)
    else:
        rcdf = poisson_1mcdf(lamb, ks, offset, series_cap)
    frac = torch.mean((n_draws[None, :] >= (ks[:, None] - offset)).float(), 1)
    coeffs = torch.where(ks <= n_power, frac / rcdf, torch.zeros((), device=device))
    return coeffs.float(), n_power, n_draws


def basic_logdet_estimator(net, x, vareps, coeffs, n_power, create_graph=False):
    """(B,) ``sum_{k<=n_power} (-1)^(k+1)/k coeff(k) <J^k eps, eps>`` with J
    the Jacobian of ``net`` at ``x`` (transposed powers via autograd VJPs,
    which leave the trace unchanged). Detached unless ``create_graph``,
    which keeps the whole series differentiable w.r.t. the net's
    parameters and ``x`` (the tabular training estimator)."""
    cap = coeffs.shape[0]
    ks = torch.arange(1, cap + 1, device=x.device)
    signs = torch.where(ks % 2 == 1, 1.0, -1.0)
    weights = signs / ks.float() * coeffs
    dims = tuple(range(1, x.ndim))
    n = min(n_power, cap)
    with torch.enable_grad():
        xg = x if create_graph and x.requires_grad else x.detach().requires_grad_(True)
        y = net(xg)
        v = vareps
        acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for k in range(n):
            v = torch.autograd.grad(y, xg, v, retain_graph=create_graph or k + 1 < n,
                                    create_graph=create_graph)[0]
            acc = acc + weights[k] * torch.sum(v * vareps, dim=dims)
    return acc if create_graph else acc.detach()


def brute_force_logdet(net, x):
    """(B,) exact ``log|det(I + J)|`` of ``net`` at each example of a small
    flat input (``brute_force_logdet``, ``logdet.py:300-337``): the
    Jacobian row by row, one VJP per output entry (the net maps each example
    on its own), then ``slogdet``. Detached."""
    B = x.shape[0]
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        y = net(xg).reshape(B, -1)
        D = y.shape[1]
        rows = [torch.autograd.grad(y[:, i].sum(), xg, retain_graph=i + 1 < D)[0].reshape(B, D)
                for i in range(D)]
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    return torch.linalg.slogdet(eye + torch.stack(rows, dim=1))[1]


def _batch_dot(a, b):
    """Per-example sum of a * b, accumulated in float32 whatever the operands'
    dtype (``_batch_dot``, ``logdet.py:138-142``)."""
    return torch.sum(a.float() * b.float(), dim=tuple(range(1, a.ndim)))


def neumann_logdet_estimator(net, x, vareps, coeffs, n_power):
    """(B,) O(1)-memory gradient estimator (``logdet.py:145-185``): the
    roulette-weighted Neumann series ``acc = sum_{k<=n_power} (-1)^k c_k
    (J^T)^k eps`` accumulated without gradient (``acc`` in ``x``'s dtype, as
    the JAX carry), then ONE differentiable VJP dotted with the probe:
    ``<J^T acc, eps>``, whose gradient w.r.t. the parameters and ``x`` is
    the log-det's. Runs in ``x``'s dtype; ``net`` follows its input's."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ys = net(xs)
        v = acc = vareps.detach()
        for k in range(1, n_power + 1):
            v = torch.autograd.grad(ys, xs, v, retain_graph=k < n_power)[0]
            w = ((1.0 if k % 2 == 0 else -1.0) * coeffs[k - 1]).to(acc.dtype)
            acc = acc + w * v
    return neumann_final(net, x, vareps, acc)


def neumann_final(net, y, vareps, acc):
    """(B,) the differentiable term closing a Neumann accumulation
    (``neumann_final``, ``logdet.py:259-275``, its VJP form): ``<J^T acc,
    eps>`` with J the Jacobian of ``net`` at ``y``, ``acc`` detached and cast
    to ``y``'s dtype, gradients to the net's parameters and ``y``. The JVP
    form (``IMNF_FINAL_FORM=jvp``) is not ported."""
    if kernel_config().final_form != "vjp":
        raise NotImplementedError("IMNF_FINAL_FORM=jvp is not ported")
    with torch.enable_grad():
        yg = y if y.requires_grad else y.detach().requires_grad_(True)
        vjp = torch.autograd.grad(net(yg), yg, acc.detach().to(y.dtype),
                                  create_graph=True)[0]
    return _batch_dot(vjp, vareps)


def residual_logdet(net, x, vareps, coeffs, n_power, dtype=torch.float32):
    """Training estimate of one net (``estimate_one``,
    ``implicit_block.py:887-898``): the Neumann estimator with ``x`` and the
    probe cast to ``dtype`` (bfloat16 under ``IMNF_BF16_EST``; the net then
    casts its parameters and buffers), returned in float32."""
    return neumann_logdet_estimator(net, x.to(dtype), vareps.to(dtype), coeffs,
                                    n_power).float()


def signed_coeffs(coeffs):
    """The roulette coefficients with the chain's ``(-1)^k`` folded in:
    ``coeffs[k-1]`` times +1 for even k, -1 for odd."""
    ks = torch.arange(1, coeffs.shape[0] + 1, device=coeffs.device)
    return torch.where(ks % 2 == 0, 1.0, -1.0) * coeffs.detach()


def neumann_pair_accs(eps_x, chain_x, eps_z, chain_z, coeffs, n_power):
    """Both nets' stop-gradient accumulations ``acc = eps + sum_{k<=n_power}
    (-1)^k coeffs[k-1] (J^T)^k eps`` (``neumann_pair_accs``,
    ``logdet.py:215-251``) through ``ops.fused_chain``, float32 (B, c, H, W).
    The probes' dtype is the chain's; ``chain_*`` is ``conv_chain_data`` at
    the linearisation point in it; ``n_power`` a host int."""
    return fused_chain.fused_neumann_chain2((eps_x.detach(), *chain_x),
                                            (eps_z.detach(), *chain_z),
                                            signed_coeffs(coeffs), n_power)
