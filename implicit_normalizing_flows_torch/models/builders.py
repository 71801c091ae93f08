"""Builders of the flat density models: the tabular recipe's chain of
implicit blocks over MLP nets.

Counterparts of ``build_lipschitz_mlp`` and ``build_tabular_model``
(``models/builders.py:24-44, 156-211`` of the JAX package) and
``parse_vnorms`` (``models/implicit_flow.py:42-45``). The nets are
``get_dense`` layers with the (2, 2) induced norm between activations; the
blocks train with the differentiable basic estimator (``neumann_grad=False,
grad_in_forward=False``, so the logged loss is the true NLL) through the
generic solver path. Not ported (raise): ``actnorm``, ``batchnorm``,
``learn_p``, ``scan_blocks`` (a JAX compile-time measure), ``exact_trace``,
``n_power_series``, other activations than ``sin`` and other vnorms than
2.

The models are built on ``device`` (the card unless the caller asks for
another), with the weights drawn from ``generator`` (default: torch's
global generator) on its device.
"""
from __future__ import annotations

from ..layers import ImplicitBlock, LipschitzNet, SequentialFlow, Sin, get_dense

ACT_FNS = {"sin": Sin}  # the tabular and toy recipes' activation


def parse_vnorms(vnorms: str):
    """'122f' -> domains [1, 2, 2], codomains [2, 2, inf]
    (``implicit_flow.py:42-45``)."""
    ps = [float("inf") if p == "f" else float(p) for p in vnorms]
    return ps[:-1], ps[1:]


def build_lipschitz_mlp(dims, activation_fn, coeff, domains, codomains, n_iterations=None,
                        atol=None, rtol=None, learn_p=False, zero_init_last=True,
                        generator=None, device="cuda"):
    """``dims[0] -> ... -> dims[-1]`` MLP of induced-norm dense layers with
    ``activation_fn`` between them (``builders.py:24-43``); the last layer,
    which projects back to the data, is zero-initialised."""
    if learn_p:
        raise NotImplementedError("learned p-orders are not ported")
    if activation_fn not in ACT_FNS:
        raise NotImplementedError(f"activation {activation_fn!r}: ported {sorted(ACT_FNS)}")
    items = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        if i > 0:
            items.append(ACT_FNS[activation_fn]())
        items.append(get_dense(
            din, dout, coeff=coeff, n_iterations=n_iterations, atol=atol, rtol=rtol,
            domain=domains[i], codomain=codomains[i],
            zero_init=zero_init_last and dout == dims[-1] and i == len(dims) - 2,
            generator=generator, device=device))
    return LipschitzNet(items)


def build_tabular_model(data_dim, dims="128-128-128-128", nblocks=20, act="sin", coeff=0.99,
                        vnorms="222222", n_lipschitz_iters=None, atol=1e-3, rtol=1e-3,
                        learn_p=False, actnorm=False, batchnorm=False, exact_trace=False,
                        brute_force=False, n_power_series=None, n_samples=1,
                        n_dist="geometric", eps_forward=1e-6, scan_blocks=False,
                        generator=None, device="cuda") -> SequentialFlow:
    """The chain of ``nblocks`` implicit blocks of ``train_tabular.py``
    (``builders.py:156-211``; the POWER recipe of ``run_tabular.sh`` at the
    defaults with ``eps_forward=1e-5``)."""
    unported = dict(actnorm=actnorm, batchnorm=batchnorm, scan_blocks=scan_blocks,
                    exact_trace=exact_trace, n_power_series=n_power_series is not None)
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"build_tabular_model: {name} is not ported")
    full_dims = [data_dim] + list(map(int, dims.split("-"))) + [data_dim]
    domains, codomains = parse_vnorms(vnorms)

    def mk_net():
        return build_lipschitz_mlp(full_dims, act, coeff, domains, codomains,
                                   n_iterations=n_lipschitz_iters, atol=atol, rtol=rtol,
                                   learn_p=learn_p, generator=generator, device=device)

    return SequentialFlow([
        ImplicitBlock(mk_net(), mk_net(), n_dist=n_dist, n_samples=n_samples,
                      brute_force=brute_force, neumann_grad=False, grad_in_forward=False,
                      eps_forward=eps_forward, device=device)
        for _ in range(nblocks)])
