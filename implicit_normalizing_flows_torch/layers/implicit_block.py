"""The implicit flow block, evaluation path: ``z`` is the root of
``(x + g_x(x)) - (z + g_z(z)) = 0`` and ``logdet|dz/dx| = logdet(I + J_gx)(x)
- logdet(I + J_gz)(z)``.

Counterpart of ``ImplicitBlock.forward`` with ``train=False``
(``layers/implicit_block.py:739-751`` of the JAX package): the fused solve
with the per-example Banach fallback on protective-break rows (``:230-271``),
the 5-slot solver telemetry (``:112-137``), the precision-ladder arguments
(``:147-186``) and the basic log-det estimator (``:826-982``, ``neumann``
off in eval). The inverse (sampling) and the training path are later
slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..config import kernel_config
from ..ops import logdet as ld
from ..ops.broyden import fixed_point_iteration
from ..ops.fused_solve import fused_broyden_solve
from .protocol import Flow


@dataclass(frozen=True)
class SolverConfig:
    """Forward-solve budgets (``implicit_block.py:53-105``)."""
    eps_forward: float = 1e-6
    threshold: int = 30
    banach_threshold: int = 1000
    warm_start: bool = False
    stall_patience: int | None = 5
    stall_rtol: float = 0.05
    stall_guard: float | None = 3.0
    newton_init: bool = True
    line_search: bool = False


def solver_diag(nstep, converged, prot, diff, eps_i):
    """[max nstep, strict-converged fraction, any prot_break, batch-RMS
    residual over the per-example tolerance, fraction within 3x eps_i]."""
    diff = diff.float()
    return torch.stack([
        nstep.max().float(), converged.float().mean(), prot.any().float(),
        torch.sqrt(torch.mean(diff ** 2)) / eps_i,
        (diff < 3.0 * eps_i).float().mean()])


_PREC_RANK = {"bf16": 0, "tf32": 1, "tf32x": 2, "f32": 3}


def fused_solve_mode():
    prec = kernel_config().solver_precision
    if prec in ("float32", "highest"):
        return "f32"
    if prec == "tf32x":
        return "tf32x"
    return "tf32"


def ladder_args(threshold):
    """``tail_mode`` / ``tail_start`` of the precision ladder from
    ``solver_tail`` (``_ladder_args``, ``implicit_block.py:159-186``)."""
    kc = kernel_config()
    t = kc.solver_tail
    if not t or t in ("none", "0"):
        return {}
    mode = fused_solve_mode()
    stages = tuple(m.strip() for m in t.split(",") if m.strip())
    bad = [m for m in stages if m not in _PREC_RANK]
    if bad:
        raise ValueError(f"IMNF_SOLVER_TAIL: unknown precision stage(s) {bad}; "
                         f"valid: {sorted(_PREC_RANK)}")
    stages = tuple(m for m in stages if _PREC_RANK[m] > _PREC_RANK.get(mode, 0))
    if not stages:
        return {}
    start = kc.ladder_start if kc.ladder_start > 0 else max(1, threshold // 2)
    return {"tail_mode": stages if len(stages) > 1 else stages[0],
            "tail_start": min(start, threshold)}


class ImplicitBlock(Flow):
    """Invertible implicit residual block (reference ``imBlock``)."""

    def __init__(self, nnet_x, nnet_z, geom_p=0.5, lamb=2.0, n_dist="geometric",
                 n_samples=1, n_exact_terms_test=20, series_cap=24,
                 eps_forward=1e-6, threshold=30, warm_start=False, device=None):
        super().__init__()
        self.nnet_x, self.nnet_z = nnet_x, nnet_z
        # geom_p stored in logit space like the reference (implicit_block.py:144)
        self.geom_p = nn.Parameter(torch.tensor(
            math.log(geom_p) - math.log1p(-geom_p), device=device))
        self.lamb = nn.Parameter(torch.tensor(float(lamb), device=device))
        self.n_dist, self.n_samples = n_dist, n_samples
        self.n_exact_terms_test, self.series_cap = n_exact_terms_test, series_cap
        kc = kernel_config()
        self.solver_cfg = SolverConfig(
            eps_forward=eps_forward,
            threshold=kc.fwd_threshold if kc.fwd_threshold is not None else threshold,
            warm_start=warm_start or kc.warm_start,
            stall_patience=kc.stall_patience if kc.stall_patience > 0 else None,
            stall_rtol=kc.stall_rtol,
            stall_guard=kc.stall_guard if kc.stall_guard > 0 else None,
            newton_init=kc.newton_init, line_search=kc.line_search)
        # [nstep, converged, prot_break, rms_over_tol, converged_3eps] of
        # the last forward
        self.solver_diag = torch.zeros(5, device=device)

    @torch.no_grad()
    def solve(self, x):
        """(z_hat, z, diag): the root, the re-attached value ``z_hat +
        g(z_hat)`` and the telemetry (``implicit_block.py:230-271``)."""
        cfg = self.solver_cfg
        data_x = self.nnet_x.conv_forward_data()
        data_z = self.nnet_z.conv_forward_data()
        if data_x is None or data_z is None:
            raise NotImplementedError("only the recipe conv stack is ported")
        res = fused_broyden_solve(
            x, data_x, data_z, threshold=cfg.threshold, eps=cfg.eps_forward,
            stall_patience=cfg.stall_patience, stall_rtol=cfg.stall_rtol,
            stall_guard=cfg.stall_guard, newton_init=cfg.newton_init,
            warm_start=cfg.warm_start, mode=fused_solve_mode(),
            line_search=cfg.line_search, **ladder_args(cfg.threshold))
        B = x.shape[0]
        zf, gf = res.result.reshape(B, -1), res.gx.reshape(B, -1)
        if bool(res.prot_break.any()):
            x_embed = (self.nnet_x(x) + x).reshape(B, -1)
            bg = lambda zz: x_embed - self.nnet_z(zz.reshape(x.shape)).reshape(B, -1)
            fb = fixed_point_iteration(bg, x.reshape(B, -1),
                                       threshold=cfg.banach_threshold,
                                       eps=cfg.eps_forward)
            take = res.prot_break[:, None]
            zf = torch.where(take, fb, zf)
            gf = torch.where(take, bg(fb) - fb, gf)
        eps_i = cfg.eps_forward * (x[0].numel() ** 0.5)
        diag = solver_diag(res.nstep, res.converged, res.prot_break, res.diff, eps_i)
        if kernel_config().debug_solver:
            print(f"fwd solve: nstep={res.nstep.tolist()} diag={diag.tolist()}")
        return zf.reshape(x.shape), (zf + gf).reshape(x.shape), diag

    def logdetgrad(self, z, x, draws):
        """(B,) logdet|dz/dx| with the basic estimator and the test exact-term
        budget (``_logdetgrad`` with ``train=False``)."""
        geom_p = torch.sigmoid(self.geom_p.detach())
        lamb = self.lamb.detach()
        coeffs, n_power, _ = ld.sample_n_dist(
            draws, self.n_dist, self.n_samples, geom_p, lamb,
            self.n_exact_terms_test, self.series_cap, x.device)
        eps_x = draws.rademacher(x.shape, x.device)
        eps_z = draws.rademacher(z.shape, z.device)
        return (ld.basic_logdet_estimator(self.nnet_x, x, eps_x, coeffs, n_power)
                - ld.basic_logdet_estimator(self.nnet_z, z, eps_z, coeffs, n_power))

    def forward(self, x, logpx=None, draws=None):
        _, z, diag = self.solve(x)
        self.solver_diag = diag
        if logpx is None:
            return z, None
        if draws is None:
            raise ValueError("stochastic logdet estimation requires draws")
        return z, logpx - self.logdetgrad(z, x, draws)
