"""The generic batched Broyden solver, its Banach fallback and the host-side
triage line.

Counterpart of ``ops/broyden.py`` of the JAX package (``broyden`` :99-337,
``fixed_point_iteration`` :340-376, ``root_solve`` :379-425,
``triage_metrics`` :428-442): a limited-memory "bad Broyden" root finder
with the inverse Jacobian approximated as ``-I + U V^T`` and one rank-1 pair
appended per iteration by :func:`~.broyden_update.broyden_update` (its CUDA
kernel for CUDA tensors). The implicit blocks whose nets are not the recipe
conv stack solve with it; the recipe stack has its fused solve
(``ops.fused_solve``).

The same semantics as the JAX solver: per-example tolerance ``eps *
sqrt(D)``, per-example freezing (a frozen row keeps its residual bit for
bit), best-iterate return, the protective break at ``1e6`` times the initial
objective, the guarded stall window, ``newton_init``, and with ``line_search`` the bounded
two-trial Armijo backtracking (``broyden.py:212-246``). The JAX loop is one
``lax.while_loop`` on the device; here it is a host loop that reads
``active.any()`` once per iteration, and under the search ``fail.any()``
once more (JAX's ``lax.cond`` on it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .broyden_update import broyden_update

PROTECT_THRES = 1e6  # reference: broyden.py:150


class BroydenResult(NamedTuple):
    result: torch.Tensor      # (B, D) best iterate per example
    gx: torch.Tensor          # (B, D) residual at the returned iterate
    nstep: torch.Tensor       # () int32, iterations run
    diff: torch.Tensor        # (B,) best objective per example
    best_step: torch.Tensor   # (B,) int32 iteration of each best iterate
    prot_break: torch.Tensor  # (B,) bool, hit the protective break
    converged: torch.Tensor   # (B,) bool, met its tolerance
    eps: torch.Tensor         # (B,) per-example tolerance


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=1))


@torch.no_grad()
def broyden(g, x0, threshold, eps, *, stall_patience=None, stall_rtol=1e-3,
            stall_guard=None, newton_init=False, line_search=False) -> BroydenResult:
    """Solve ``g(x) = 0`` for a batch of independent (B, D) problems from
    ``x0`` with at most ``threshold`` iterations (``broyden``,
    ``broyden.py:99-337``; the arguments are the JAX function's)."""
    if x0.ndim != 2:
        raise ValueError(f"broyden expects (B, D) input, got {tuple(x0.shape)}")
    B, D = x0.shape
    dt, dev = x0.dtype, x0.device
    eps_i = torch.full((B,), eps * D ** 0.5, dtype=dt, device=dev)
    x, gx = x0, g(x0)
    init_obj = _norm(gx)
    update = gx if newton_init else -gx
    # both panels plane-major (B, K, D): the JAX solver's Us is (B, D, K)
    UTs = torch.zeros(B, threshold, D, dtype=dt, device=dev)
    VTs = torch.zeros(B, threshold, D, dtype=dt, device=dev)
    active = init_obj >= eps_i
    best_x, best_gx, best_obj = x, gx, init_obj
    best_step = torch.zeros(B, dtype=torch.int32, device=dev)
    prot = torch.zeros(B, dtype=torch.bool, device=dev)
    snapshot = init_obj
    nstep = 0
    while nstep < threshold and bool(active.any()):
        act = active[:, None]
        delta_x = torch.where(act, update, 0.0)
        x_new = x + delta_x
        gx_new = torch.where(act, g(x_new), gx)
        if line_search:
            x_new, gx_new = _armijo(g, x, gx, delta_x, x_new, gx_new, active)
            delta_x = torch.where(act, x_new - x, 0.0)
        delta_gx = gx_new - gx
        nstep += 1
        obj = _norm(gx_new)
        improved = active & (obj < best_obj)
        best_x = torch.where(improved[:, None], x_new, best_x)
        best_gx = torch.where(improved[:, None], gx_new, best_gx)
        best_obj = torch.where(improved, obj, best_obj)
        best_step = torch.where(improved, nstep, best_step)
        bad = ~torch.isfinite(obj) | (obj > init_obj * PROTECT_THRES)
        prot = prot | (active & bad)
        next_active = active & (obj >= eps_i) & ~bad
        if stall_patience is not None and nstep % stall_patience == 0:
            # each example's best objective against its value one window ago
            stalled = best_obj > snapshot * (1.0 - stall_rtol)
            if stall_guard is not None:
                stalled = stalled & (best_obj < stall_guard * eps_i)
            next_active = next_active & ~stalled
            snapshot = best_obj
        update = broyden_update(UTs, VTs, delta_x, delta_gx, gx_new, active,
                                (nstep - 1) % threshold)
        x, gx, active = x_new, gx_new, next_active
    return BroydenResult(best_x, best_gx, torch.tensor(nstep, dtype=torch.int32, device=dev),
                         best_obj, best_step, prot, best_obj < eps_i, eps_i)


C1 = 1e-4  # the Armijo constant (reference scalar_search_armijo, broyden.py:24)


def _armijo(g, x, gx, delta_x, x1, g1, active):
    """The accepted (x_new, gx_new) of one iteration (``broyden.py:
    212-246``): rows failing ``phi1 <= phi0 (1 - c1)`` try the quadratic
    step ``sq = clip(phi0 / (2 phi1 + 1e-30), 1e-2, 1)``, then its half,
    each on the whole batch, and keep the full step where both fail."""
    act = active[:, None]
    phi0, phi1 = torch.sum(gx * gx, 1), torch.sum(g1 * g1, 1)
    fail = active & (phi1 > phi0 * (1.0 - C1))
    if not bool(fail.any()):
        return x1, g1
    sq = torch.clamp(phi0 / (2.0 * phi1 + 1e-30), 1e-2, 1.0)
    x_q = x + sq[:, None] * delta_x
    g_q = torch.where(act, g(x_q), gx)
    ok_q = torch.sum(g_q * g_q, 1) <= phi0 * (1.0 - C1 * sq)
    sh = sq * 0.5
    x_h = x + sh[:, None] * delta_x
    g_h = torch.where(act, g(x_h), gx)
    ok_h = torch.sum(g_h * g_h, 1) <= phi0 * (1.0 - C1 * sh)
    take_q, take_h = (fail & ok_q)[:, None], (fail & ~ok_q & ok_h)[:, None]
    return (torch.where(take_q, x_q, torch.where(take_h, x_h, x1)),
            torch.where(take_q, g_q, torch.where(take_h, g_h, g1)))


@torch.no_grad()
def fixed_point_iteration(g, y, threshold=1000, eps=1e-5):
    """Picard iteration ``x <- g(x)`` from ``g(y)`` with the reference's
    elementwise stop ``(x - x_prev)^2 / (eps + eps|y|) < 1``
    (``implicit_block.py:17-28``); converged rows freeze while the others
    continue."""
    shape = y.shape
    y2 = y.reshape(y.shape[0], -1)
    g2 = lambda x: g(x.reshape(shape)).reshape(y2.shape)
    tol = eps + eps * torch.abs(y2)
    row_done = lambda x, xp: torch.all((x - xp) ** 2 / tol < 1.0, dim=1)
    x, x_prev = g2(y2), y2
    active = ~row_done(x, x_prev)
    i = 0
    while bool(active.any()) and i <= threshold:
        a = active[:, None]
        x_new = torch.where(a, g2(x), x)
        x_prev = torch.where(a, x, x_prev)
        x = x_new
        active = active & ~row_done(x, x_prev)
        i += 1
    return x.reshape(shape)


@torch.no_grad()
def root_solve(g, banach_g, x0, threshold, eps, banach_x0=None, banach_threshold=1000,
               stall_patience=None, stall_rtol=1e-3, stall_guard=None, newton_init=False,
               line_search=False):
    """:func:`broyden`, then the Banach fallback ``z <- banach_g(z)`` from
    ``banach_x0`` (default ``x0``) for the rows that hit the protective
    break, with their residual ``g`` recomputed at the fallback root
    (``root_solve``, ``broyden.py:379-425``). Returns ``(root, result)``."""
    res = broyden(g, x0, threshold, eps, stall_patience=stall_patience,
                  stall_rtol=stall_rtol, stall_guard=stall_guard,
                  newton_init=newton_init, line_search=line_search)
    if bool(res.prot_break.any()):
        fb = fixed_point_iteration(banach_g, x0 if banach_x0 is None else banach_x0,
                                   threshold=banach_threshold, eps=eps)
        take = res.prot_break[:, None]
        res = res._replace(result=torch.where(take, fb, res.result),
                           gx=torch.where(take, g(fb), res.gx))
    return res.result, res


def triage_metrics(m, name: str = "forward") -> str | None:
    """Warning line when the protective break fired (the per-row Banach
    fallback has already patched those rows), else None."""
    prot = float(m.get("broyden_prot_break", 0.0))
    if prot <= 0:
        return None
    return (f"WARNING: Hit Protective Break in {name} solve "
            f"(per-row Banach fallback applied; "
            f"BroydenIters {float(m.get('broyden_nstep', 0.0)):.1f}, "
            f"Converged {float(m.get('broyden_converged', 0.0)):.2f})")
