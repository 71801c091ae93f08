"""The port's generic Broyden solver (``ops.broyden.broyden`` and
``root_solve``) against the JAX package's on the same residual: ``g(z) =
x_embed - net(z) - z`` with a contractive sin MLP (``net = W2 sin-act(W1 z +
b1) + b2``, ``|W1| |W2| = 0.9``), numpy weights and inputs from a seed, the
JAX solver once on its XLA formulas (``IMNF_PALLAS=0``) and once on its
Pallas rank-1 update in interpret mode (``IMNF_PALLAS=1``).

Cases: the forward budget with the default stall window (D 6 and 43), the
reference semantics (-g first step, no stall window), the backward budget (4
iterations, eps 1e-10, which no example reaches), the stall window
unguarded and guarded (patience 2, rtol 0.97: an example must improve 33x
per window; eps 1e-4 ends the solves while the objectives are far above
float32's noise, so each window's decision is the same on both sides), and
a forced protective break through ``root_solve``: some rows' residual grows
by 1e7 times their step, so they break at the first iteration and take the
Banach fallback, with their residual recomputed at the fallback root.

Per example: root and residual within rtol 1e-5 / atol 1e-6, objective the
same, and nstep, best_step, converged and prot_break exactly equal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.broyden import broyden as jbroyden
from implicit_normalizing_flows_tpu.ops.broyden import root_solve as jroot_solve
from implicit_normalizing_flows_torch.ops.broyden import broyden, root_solve

B, H = 16, 16
PROT_ROWS = [2, 9]
FWD = dict(threshold=30, eps=1e-6, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
           newton_init=True)
CASES = {
    "forward": (6, FWD),
    "forward_d43": (43, FWD),
    "reference": (6, dict(threshold=30, eps=1e-6, newton_init=False)),
    "backward_budget": (6, dict(FWD, threshold=4, eps=1e-10)),
    "stall": (6, dict(threshold=30, eps=1e-4, stall_patience=2, stall_rtol=0.97,
                      newton_init=True)),
    "stall_guarded": (43, dict(threshold=30, eps=1e-4, stall_patience=2, stall_rtol=0.97,
                               stall_guard=300.0, newton_init=True)),
}


def problem(D, seed=0, lip=0.9):
    rng = np.random.RandomState(seed)
    W1 = rng.normal(size=(H, D))
    W1 /= np.linalg.norm(W1, 2)
    W2 = rng.normal(size=(D, H))
    W2 *= lip / np.linalg.norm(W2, 2)
    b1, b2 = rng.normal(size=H) * 0.3, rng.normal(size=D) * 0.3
    x = rng.normal(size=(B, D))
    xe = x + 0.5 * np.tanh(rng.normal(size=(B, D)))
    return [np.asarray(a, np.float32) for a in (W1, b1, W2, b2, x, xe)]


def residuals(arrays, lib, prot=False):
    """(g, banach_g) on ``lib``'s arrays; with ``prot`` the rows PROT_ROWS
    add 1e7 (z - x) to g (not to the Banach map)."""
    W1, b1, W2, b2, x, xe = [jnp.asarray(a) if lib is jnp else torch.from_numpy(a)
                             for a in arrays]
    net = lambda z: (lib.sin(2.0 * math.pi * (z @ W1.T + b1)) / math.pi * 0.5) @ W2.T + b2
    banach = lambda z: xe - net(z)
    mask = np.zeros((B, 1), np.float32)
    mask[PROT_ROWS] = 1e7
    mask = jnp.asarray(mask) if lib is jnp else torch.from_numpy(mask)
    if prot:
        return (lambda z: banach(z) - z + mask * (z - x)), banach
    return (lambda z: banach(z) - z), banach


def check(res_t, res_j):
    f = lambda a: np.asarray(a)
    for name in ("result", "gx"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(), f(getattr(res_j, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(res_t.diff.numpy(), f(res_j.diff), rtol=1e-5, atol=1e-6)
    assert int(res_t.nstep) == int(res_j.nstep)
    for name in ("best_step", "converged", "prot_break"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(), f(getattr(res_j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("case", list(CASES))
def test_broyden_matches_jax(monkeypatch, case, pallas):
    monkeypatch.setenv("IMNF_PALLAS", pallas)
    D, kw = CASES[case]
    arrays = problem(D)
    res_j = jbroyden(residuals(arrays, jnp)[0], jnp.asarray(arrays[4]), **kw)
    res_t = broyden(residuals(arrays, torch)[0], torch.from_numpy(arrays[4]), **kw)
    check(res_t, res_j)
    if case.startswith("stall"):  # the window froze examples short of eps
        assert not bool(res_t.converged.all()) and int(res_t.nstep) < kw["threshold"]


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_root_solve_protective_break_takes_banach_fallback(monkeypatch, pallas):
    monkeypatch.setenv("IMNF_PALLAS", pallas)
    arrays = problem(6, seed=1)
    x0 = arrays[4]
    g_j, bg_j = residuals(arrays, jnp, prot=True)
    g_t, bg_t = residuals(arrays, torch, prot=True)
    z_j, res_j = jroot_solve(g_j, bg_j, jnp.asarray(x0), banach_x0=jnp.asarray(x0), **FWD)
    z_t, res_t = root_solve(g_t, bg_t, torch.from_numpy(x0), banach_x0=torch.from_numpy(x0),
                            **FWD)
    check(res_t, res_j)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
    assert res_t.prot_break.nonzero().flatten().tolist() == PROT_ROWS
    # the patched rows' residual is g at the fallback root, with its 1e7 term
    np.testing.assert_allclose(res_t.gx.numpy(), g_t(z_t).numpy(), rtol=1e-6)
