"""The implicit flow block: ``z`` is the root of
``(x + g_x(x)) - (z + g_z(z)) = 0`` and ``logdet|dz/dx| = logdet(I + J_gx)(x)
- logdet(I + J_gz)(z)``.

Counterpart of ``ImplicitBlock.forward`` (``layers/implicit_block.py:739-751``
of the JAX package): the fused solve with the per-example Banach fallback on
protective-break rows (``:230-271``), the 5-slot solver telemetry
(``:112-137``) and the precision-ladder arguments (``:147-186``).

* Evaluation (``train=False``): the basic log-det estimator with the test
  exact-term budget (``:826-982``, ``neumann`` off).
* Training (``train=True``): the implicit gradient as a
  ``torch.autograd.Function`` (``_make_implicit_forward``'s custom VJP and
  ``_make_bwd_core``, ``:316-466``). Its forward solves without gradient
  and returns the re-attached ``z = z_hat + g(z_hat)``; its backward solves
  ``u (I + J_gz) = grad`` at the re-attached z (``fused_backward_solve``)
  and runs the re-attachment VJP at ``z_hat`` (``fused_reattach_vjp``),
  whose gradients w.r.t. the effective kernels, biases and slopes autograd
  pulls back through ``conv_forward_data`` to the raw parameters (the
  soft-normalisation and softplus chain). The log-det is the Neumann
  gradient estimator, in bfloat16 under ``IMNF_BF16_EST`` (``:880-898``):
  with ``grad_in_forward`` (``--mem-eff True``) under non-reentrant
  ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``
  (``:907-910``); without it (``--mem-eff False``, the default) both nets'
  stop-gradient chains run in ``ops.fused_chain`` at the dtype casts of x
  and the re-attached z, and the differentiable final term ``<acc, J_g
  eps>`` of both nets in ``ops.fused_final`` at float32 x and z
  (``:923-965``), whose gradient to z flows into the implicit gradient.

Under ``IMNF_FUSED_BLOCK=1`` training at ``--mem-eff False`` takes the
merged path on the blocks with H*W >= ``IMNF_FUSED_SOLVE_MIN_HW``
(``_merged_forward_ok`` / ``_forward_merged``, ``:660-737``): the roulette
and both probes are drawn first, then :class:`_ImplicitForwardEstFunction`
runs ``ops.fused_block.fused_block_forward`` (the solve and both nets'
chains, net z linearised at ``z_hat``), the Banach fallback on
protective-break rows with their accs reset to the probes (the JAX
package's documented deviation, ``:469-482``), and returns the re-attached
z; its backward is the implicit gradient of :class:`_ImplicitFunction`.
The estimate closes with ``ops.logdet.neumann_final`` of each net in the
dtype of ``IMNF_BF16_EST`` (cuDNN autograd on the card, XLA in JAX).

Nets that are not the recipe conv stack (``conv_forward_data()`` is None:
the tabular and toy MLPs) take the generic path (``:273-314, 391-464``):
the forward solve is ``ops.broyden.root_solve`` on ``g(z) = x + g_x(x) -
g_z(z) - z`` with the Banach fallback, whose secant updates run the
``broyden_update`` kernel; the implicit gradient is
:class:`_GenericImplicitFunction` over both nets' effective weights and
biases (its backward solves ``u (I + J_gz) = grad`` with ``ops.broyden.
broyden`` on autograd VJPs of net z, then takes the re-attachment VJP by
autograd). Its solves run float32 products (``IMNF_SOLVER_PRECISION``'s
default ``tensorfloat32`` is float32 in the JAX package on a CPU; the port
never uses native TF32). Its log-det is the exact brute force in evaluation
of flat inputs with D <= 10, else the basic estimator, differentiable in
training (``neumann_grad=False``, ``:834-840, 857-898``).

The inverse (sampling, ``ImplicitBlock.inverse``, ``:753-823``) solves
``x : x + g_x(x) = z + g_z(z)`` for a latent z: the same fused solve with
the nets' roles swapped (net z embeds z, net x is solved, warm start x0 =
z) at ``eps_sample`` (``_fused_inverse``, ``:791-823``), so on CUDA tensors
it launches row 1's four kernels (``conv3x3_in``, ``conv1x1_mid``,
``conv3x3_out``, ``broyden_step``); the protective-break rows take the
Banach fallback ``x <- z + g_z(z) - g_x(x)`` from z (:meth:`_banach_patch`,
shared with the forward). With ``logpz`` it adds the evaluation
estimator's log-det at the solved x (``:765-768``). No gradient flows
through it (the JAX package stops every gradient there). Its 8x8 solves
run the kernels where the JAX package would send them to XLA (its
``IMNF_FUSED_SOLVE_MIN_HW`` gate, ``:213``), as the forward's do: the same
semantics on another route. On the generic path (tabular and toy nets) the
inverse raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import kernel_config
from ..ops import logdet as ld
from ..ops.broyden import broyden, fixed_point_iteration, root_solve
from ..ops.fused_block import fused_block_forward
from ..ops.fused_final import fused_final_pair
from ..ops.fused_solve import fused_broyden_solve
from ..ops.implicit_grad import (DATA_KEYS, fused_backward_solve,
                                 fused_reattach_vjp)
from .protocol import Flow


@dataclass(frozen=True)
class SolverConfig:
    """Solver budgets (``implicit_block.py:53-105``); ``eps_sample`` is the
    inverse's tolerance."""
    eps_forward: float = 1e-6
    eps_backward: float = 1e-10
    eps_sample: float = 1e-5
    threshold: int = 30
    threshold_backward: int = 4
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


class _ImplicitFunction(torch.autograd.Function):
    """``z = z_hat + g(z_hat)`` with the implicit gradient. Inputs: the
    block, x, then the effective tensors of ``conv_forward_data`` of net x
    and net z (``DATA_KEYS`` order), computed with gradient from the raw
    parameters by the caller."""

    @staticmethod
    def forward(ctx, block, x, *tensors):
        k = len(DATA_KEYS)
        data_x, data_z = block._data(tensors[:k], "x"), block._data(tensors[k:], "z")
        z_hat, z, diag = block.solve(x, data_x, data_z)
        block.solver_diag = diag
        ctx.block = block
        ctx.save_for_backward(x, z_hat, z, *tensors)
        return z

    @staticmethod
    def backward(ctx, grad):
        return (None, *_implicit_grads(ctx, grad))


def _implicit_grads(ctx, grad):
    """The implicit gradient (``_make_bwd_core``, ``implicit_block.py:
    350-466``): solve ``u (I + J_gz) = grad`` at the re-attached z, then the
    re-attachment VJP at ``z_hat``; returns d_x and the gradients of both
    nets' ``DATA_KEYS`` tensors, from what the forward saved: x, z_hat, z,
    then the tensors."""
    block = ctx.block
    x, z_hat, z, *tensors = ctx.saved_tensors
    k = len(DATA_KEYS)
    data_x, data_z = block._data(tensors[:k], "x"), block._data(tensors[k:], "z")
    u = block.backward_solve(grad, z).u
    d_x, d_ax, d_az = fused_reattach_vjp(
        x, z_hat, u, data_x, data_z, mode=kernel_config().reattach_precision)
    return (d_x.to(x.dtype), *(d_ax[n] for n in DATA_KEYS),
            *(d_az[n] for n in DATA_KEYS))


class _ImplicitForwardEstFunction(torch.autograd.Function):
    """The merged forward (``_make_implicit_forward_est``,
    ``implicit_block.py:469-556``): ``(z, diag, acc_x, acc_z)`` with ``z =
    z_hat + g(z_hat)`` and the implicit gradient of
    :class:`_ImplicitFunction`; the probes, coefficients, diag and accs get
    no gradient. Inputs: the block, x, eps_x, eps_z, the signed
    coefficients, n_power (host int), then both nets' ``DATA_KEYS``
    tensors."""

    @staticmethod
    def forward(ctx, block, x, eps_x, eps_z, signed, n_power, *tensors):
        k = len(DATA_KEYS)
        data_x, data_z = block._data(tensors[:k], "x"), block._data(tensors[k:], "z")
        z_hat, z, diag, acc_x, acc_z = block.solve_merged(x, data_x, data_z, eps_x,
                                                          eps_z, signed, n_power)
        ctx.block = block
        ctx.save_for_backward(x, z_hat, z, *tensors)
        ctx.mark_non_differentiable(diag, acc_x, acc_z)
        return z, diag, acc_x, acc_z

    @staticmethod
    def backward(ctx, grad, _diag, _acc_x, _acc_z):
        d_x, *d_tensors = _implicit_grads(ctx, grad)
        return (None, d_x, None, None, None, None, *d_tensors)


class _GenericImplicitFunction(torch.autograd.Function):
    """``z = z_hat + g(z_hat)`` with the implicit gradient on the generic
    path (``_make_implicit_forward`` with ``_make_bwd_core``'s plain branch,
    ``implicit_block.py:273-314, 391-464``). Inputs: the block, x, the
    number of net x's tensors, then ``lipschitz_tensors()`` of net x and of
    net z, computed with gradient from the raw parameters by the caller."""

    @staticmethod
    def forward(ctx, block, x, n_x, *tensors):
        z_hat, z, diag = block.solve(x, tensors[:n_x], tensors[n_x:])
        block.solver_diag = diag
        ctx.block, ctx.n_x = block, n_x
        ctx.save_for_backward(x, z_hat, z, *tensors)
        return z

    @staticmethod
    def backward(ctx, grad):
        block = ctx.block
        x, z_hat, z, *tensors = ctx.saved_tensors
        u = block.backward_solve(grad, z).result.reshape(grad.shape)
        d_x, *d_tensors = block.reattach_vjp(x, z_hat, u, tensors, ctx.n_x)
        return (None, d_x, None, *d_tensors)


class ImplicitBlock(Flow):
    """Invertible implicit residual block (reference ``imBlock``)."""

    # Hutchinson probes per training step; only one is ported (more raise)
    n_probes = 1

    def __init__(self, nnet_x, nnet_z, geom_p=0.5, lamb=2.0, n_dist="geometric",
                 n_samples=1, n_exact_terms=2, n_exact_terms_test=20,
                 series_cap=24, neumann_grad=True, grad_in_forward=True,
                 eps_forward=1e-6, eps_backward=1e-10, threshold=30,
                 warm_start=False, brute_force=False, device=None):
        super().__init__()
        self.nnet_x, self.nnet_z = nnet_x, nnet_z
        # geom_p stored in logit space like the reference (implicit_block.py:144)
        self.geom_p = nn.Parameter(torch.tensor(
            math.log(geom_p) - math.log1p(-geom_p), device=device))
        self.lamb = nn.Parameter(torch.tensor(float(lamb), device=device))
        self.n_dist, self.n_samples = n_dist, n_samples
        self.n_exact_terms, self.n_exact_terms_test = n_exact_terms, n_exact_terms_test
        self.series_cap = series_cap
        self.neumann_grad, self.grad_in_forward = neumann_grad, grad_in_forward
        self.brute_force = brute_force
        kc = kernel_config()
        self.solver_cfg = SolverConfig(
            eps_forward=eps_forward, eps_backward=eps_backward,
            threshold=kc.fwd_threshold if kc.fwd_threshold is not None else threshold,
            threshold_backward=(kc.bwd_threshold if kc.bwd_threshold is not None
                                else min(4, threshold)),
            warm_start=warm_start or kc.warm_start,
            stall_patience=kc.stall_patience if kc.stall_patience > 0 else None,
            stall_rtol=kc.stall_rtol,
            stall_guard=kc.stall_guard if kc.stall_guard > 0 else None,
            newton_init=kc.newton_init, line_search=kc.line_search)
        # [nstep, converged, prot_break, rms_over_tol, converged_3eps] of
        # the last forward
        self.solver_diag = torch.zeros(5, device=device)
        # estimator telemetry of the last training forward (loops.py:78-102)
        self.last_n_samples = torch.zeros(n_samples, device=device)
        self.last_firmom = torch.zeros(1, device=device)
        self.last_secmom = torch.zeros(1, device=device)

    def generic(self):
        """True when a net is not the recipe conv stack (its
        ``conv_forward_data()`` is None): the generic solver path."""
        return self.nnet_x._recipe() is None or self.nnet_z._recipe() is None

    def _data(self, tensors, net):
        """A ``conv_forward_data`` dict from its tensors (DATA_KEYS order)."""
        preact = (self.nnet_x if net == "x" else self.nnet_z)._recipe()[2]
        return dict(zip(DATA_KEYS, tensors), preact=preact)

    def _forward_data(self):
        return self.nnet_x.conv_forward_data(), self.nnet_z.conv_forward_data()

    @torch.no_grad()
    def solve(self, x, data_x=None, data_z=None):
        """(z_hat, z, diag): the root, the re-attached value ``z_hat +
        g(z_hat)`` and the telemetry (``implicit_block.py:230-314``).
        ``data_*`` is ``conv_forward_data()``, or ``lipschitz_tensors()`` on
        the generic path (default: the nets' own)."""
        if self.generic():
            return self._generic_solve(x, data_x, data_z)
        if data_x is None or data_z is None:
            data_x, data_z = self._forward_data()
        res = fused_broyden_solve(x, data_x, data_z, **self._fused_solve_kwargs())
        zf, gf, diag = self._banach_patch(x, res, self.nnet_x, self.nnet_z,
                                          self.solver_cfg.eps_forward)
        return zf.reshape(x.shape), (zf + gf).reshape(x.shape), diag

    @torch.no_grad()
    def solve_inverse(self, z):
        """(x, diag): the root of ``x + g_x(x) = z + g_z(z)`` and its
        telemetry (``_fused_inverse``, ``implicit_block.py:791-823``): the
        fused solve with net z embedding z and net x solved, at
        ``eps_sample``, then the Banach fallback from z on the
        protective-break rows."""
        if self.generic():
            raise NotImplementedError(
                "the inverse off the recipe conv stack (the generic solver path of the "
                "tabular and toy nets) is not ported: ROADMAP module item 6")
        data_x, data_z = self._forward_data()
        eps = self.solver_cfg.eps_sample
        res = fused_broyden_solve(z, data_z, data_x, **self._fused_solve_kwargs(eps))
        xf, _, diag = self._banach_patch(z, res, self.nnet_z, self.nnet_x, eps, "inv")
        return xf.reshape(z.shape), diag

    def _fused_solve_kwargs(self, eps=None):
        """The fused solve's budget, tolerance (default ``eps_forward``),
        precision mode and ladder (``implicit_block.py:230-250``)."""
        cfg = self.solver_cfg
        return dict(threshold=cfg.threshold, eps=cfg.eps_forward if eps is None else eps,
                    stall_patience=cfg.stall_patience, stall_rtol=cfg.stall_rtol,
                    stall_guard=cfg.stall_guard, newton_init=cfg.newton_init,
                    warm_start=cfg.warm_start, mode=fused_solve_mode(),
                    line_search=cfg.line_search, **ladder_args(cfg.threshold))

    def _banach_patch(self, a, res, net_a, net_b, eps, label="fwd"):
        """(b, g, diag) of a fused solve's result ``res`` for the root b of
        ``a + net_a(a) = b + net_b(b)``, flat (B, D), with the
        protective-break rows' root and residual taken from the Banach
        fallback ``b <- a + net_a(a) - net_b(b)`` from a at ``eps``, and the
        telemetry (``implicit_block.py:230-271, 808-821``). The forward
        passes net x, net z and ``eps_forward``; the inverse net z, net x
        and ``eps_sample``."""
        cfg = self.solver_cfg
        B = a.shape[0]
        bf, gf = res.result.reshape(B, -1), res.gx.reshape(B, -1)
        if bool(res.prot_break.any()):
            a_embed = (net_a(a) + a).reshape(B, -1)
            bg = lambda bb: a_embed - net_b(bb.reshape(a.shape)).reshape(B, -1)
            fb = fixed_point_iteration(bg, a.reshape(B, -1),
                                       threshold=cfg.banach_threshold, eps=eps)
            take = res.prot_break[:, None]
            bf = torch.where(take, fb, bf)
            gf = torch.where(take, bg(fb) - fb, gf)
        eps_i = eps * (a[0].numel() ** 0.5)
        diag = solver_diag(res.nstep, res.converged, res.prot_break, res.diff, eps_i)
        if kernel_config().debug_solver:
            print(f"{label} solve: nstep={res.nstep.tolist()} diag={diag.tolist()}")
        return bf, gf, diag

    @torch.no_grad()
    def solve_merged(self, x, data_x, data_z, eps_x, eps_z, signed, n_power):
        """(z_hat, z, diag, acc_x, acc_z) of the merged forward
        (``_make_implicit_forward_est``'s ``run``, ``implicit_block.py:
        487-531``): ``fused_block_forward``, then the Banach fallback on the
        protective-break rows, whose accs are reset to the probes."""
        res, acc_x, acc_z = fused_block_forward(x, data_x, data_z, eps_x, eps_z, signed,
                                                n_power, **self._fused_solve_kwargs())
        zf, gf, diag = self._banach_patch(x, res, self.nnet_x, self.nnet_z,
                                          self.solver_cfg.eps_forward)
        take = res.prot_break[:, None, None, None]
        acc_x = torch.where(take, eps_x.float(), acc_x)
        acc_z = torch.where(take, eps_z.float(), acc_z)
        return zf.reshape(x.shape), (zf + gf).reshape(x.shape), diag, acc_x, acc_z

    @torch.no_grad()
    def _generic_solve(self, x, tx=None, tz=None):
        """The generic forward solve (``solve_z``, ``implicit_block.py:
        273-314``): ``root_solve`` of ``g(z) = x_embed - g_z(z) - z`` from
        the warm start (or zeros), the Banach fallback from x."""
        cfg = self.solver_cfg
        tx = self.nnet_x.lipschitz_tensors() if tx is None else tx
        tz = self.nnet_z.lipschitz_tensors() if tz is None else tz
        B = x.shape[0]
        x_embed = (self.nnet_x.apply_tensors(tx, x) + x).reshape(B, -1)
        banach_g = lambda zf: x_embed - self.nnet_z.apply_tensors(
            tz, zf.reshape(x.shape)).reshape(B, -1)
        g = lambda zf: banach_g(zf) - zf
        xf = x.reshape(B, -1)
        zf, res = root_solve(
            g, banach_g, xf if cfg.warm_start else torch.zeros_like(xf),
            threshold=cfg.threshold, eps=cfg.eps_forward, banach_x0=xf,
            banach_threshold=cfg.banach_threshold, stall_patience=cfg.stall_patience,
            stall_rtol=cfg.stall_rtol, stall_guard=cfg.stall_guard,
            newton_init=cfg.newton_init, line_search=cfg.line_search)
        diag = solver_diag(res.nstep, res.converged, res.prot_break, res.diff, res.eps[0])
        if kernel_config().debug_solver:
            print(f"fwd solve: nstep={int(res.nstep)} diag={diag.tolist()}")
        return zf.reshape(x.shape), (zf + res.gx).reshape(x.shape), diag

    def _bwd_dtype(self):
        mode = kernel_config().bwd_precision
        if mode not in ("bf16", "f32"):
            raise ValueError(f"IMNF_BWD_PRECISION {mode!r}: the port takes 'bf16' | 'f32'")
        return mode, torch.bfloat16 if mode == "bf16" else torch.float32

    @torch.no_grad()
    def backward_solve(self, grad, z):
        """Solve ``u (I + J_gz(z)) = grad`` at the re-attached z with the
        backward budget (``_make_bwd_core``, ``implicit_block.py:350-412``):
        the linearisation is taken in ``IMNF_BWD_PRECISION`` (bf16: net z
        run on bfloat16-cast parameters, buffers and z). Returns the
        solver's result, whose ``u`` (fused) or ``result`` (generic) is the
        solution."""
        if self.generic():
            return self._generic_backward_solve(grad, z)
        cfg = self.solver_cfg
        mode, dtype = self._bwd_dtype()
        cd = self.nnet_z.conv_chain_data(z.detach(), dtype)
        res = fused_backward_solve(
            grad.detach().float(), cd, threshold=cfg.threshold_backward,
            eps=cfg.eps_backward, stall_patience=cfg.stall_patience,
            stall_rtol=cfg.stall_rtol, stall_guard=cfg.stall_guard,
            newton_init=cfg.newton_init, line_search=cfg.line_search, mode=mode)
        if kernel_config().debug_solver:
            print(f"bwd solve: nstep={res.nstep.tolist()} best={float(res.diff.max()):.3e}")
        return res

    @torch.no_grad()
    def _generic_backward_solve(self, grad, z):
        """The generic backward solve (``implicit_block.py:391-412``):
        ``broyden`` from zeros on ``u -> u + J_gz(z)^T u - grad``, the
        VJPs by autograd through net z (in bf16: on bfloat16-cast
        parameters, buffers and z, the cotangent cast to bfloat16 and the
        VJP back to float32)."""
        cfg = self.solver_cfg
        _, dtype = self._bwd_dtype()
        B = z.shape[0]
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            y = self.nnet_z(zz.to(dtype)).float()
        gflat = grad.detach().float().reshape(B, -1)

        def gfun(uf):
            vjp = torch.autograd.grad(y, zz, uf.reshape(z.shape), retain_graph=True)[0]
            return (vjp.reshape(B, -1) + uf) - gflat

        res = broyden(gfun, torch.zeros_like(gflat), cfg.threshold_backward,
                      cfg.eps_backward, stall_patience=cfg.stall_patience,
                      stall_rtol=cfg.stall_rtol, stall_guard=cfg.stall_guard,
                      newton_init=cfg.newton_init, line_search=cfg.line_search)
        if kernel_config().debug_solver:
            print(f"bwd solve: nstep={int(res.nstep)} best={float(res.diff.max()):.3e}")
        return res

    def reattach_vjp(self, x, z_hat, u, tensors, n_x):
        """The generic re-attachment VJP (``implicit_block.py:457-464``): the
        VJP with cotangent u of ``x + g_x(x) - g_z(z_hat)`` w.r.t. x and
        both nets' ``tensors`` (``lipschitz_tensors()`` of net x, then of
        net z), by autograd."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            ts = [t.detach().requires_grad_(True) for t in tensors]
            out = (xx + self.nnet_x.apply_tensors(ts[:n_x], xx)
                   - self.nnet_z.apply_tensors(ts[n_x:], z_hat))
            return torch.autograd.grad(out, [xx, *ts], u)

    def logdetgrad(self, z, x, draws, train=False):
        """(B,) logdet|dz/dx| (``_logdetgrad``, ``implicit_block.py:826-982``):
        for flat inputs with D <= 10, in evaluation or under
        ``brute_force``, the exact brute force; else in evaluation the basic
        estimator with the test exact-term budget; in training with
        ``n_exact_terms`` the Neumann gradient estimator, or on the generic
        path (``neumann_grad=False``) the differentiable basic estimator."""
        if (self.brute_force or not train) and x.ndim == 2 and x.shape[1] <= 10:
            if train:
                raise NotImplementedError("the brute-force log-det in training is not ported")
            return (ld.brute_force_logdet(self.nnet_x, x)
                    - ld.brute_force_logdet(self.nnet_z, z))
        geom_p = torch.sigmoid(self.geom_p.detach())
        lamb = self.lamb.detach()
        generic = self.generic()
        if train:
            if generic and self.neumann_grad:
                raise NotImplementedError(
                    "training with neumann_grad=True off the recipe conv stack "
                    "(the generic solver path) is not ported")
            if not generic and not self.neumann_grad:
                raise NotImplementedError(
                    "training with neumann_grad=False on the recipe conv stack is not ported")
            if generic and self.grad_in_forward:
                raise NotImplementedError(
                    "the basic estimator under grad_in_forward is not ported")
            if self.n_probes > 1:
                raise NotImplementedError("training with n_probes > 1 is not ported")
            if not generic and kernel_config().final_form != "vjp":
                raise NotImplementedError("IMNF_FINAL_FORM=jvp is not ported")
        offset = self.n_exact_terms if train else self.n_exact_terms_test
        coeffs, n_power, n_draws = ld.sample_n_dist(
            draws, self.n_dist, self.n_samples, geom_p, lamb, offset,
            self.series_cap, x.device)
        eps_x = draws.rademacher(x.shape, x.device)
        eps_z = draws.rademacher(z.shape, z.device)
        if not train or generic:
            return self._estimator_moments(
                ld.basic_logdet_estimator(self.nnet_x, x, eps_x, coeffs, n_power, train)
                - ld.basic_logdet_estimator(self.nnet_z, z, eps_z, coeffs, n_power, train),
                n_draws, train)
        dtype = torch.bfloat16 if kernel_config().bf16_est else torch.float32
        if self.grad_in_forward:
            def estimate(net, y, eps):
                return checkpoint(ld.residual_logdet, net, y, eps, coeffs, n_power,
                                  dtype, use_reentrant=False)

            logdet = estimate(self.nnet_x, x, eps_x) - estimate(self.nnet_z, z, eps_z)
        else:
            logdet = self._fused_logdet(x, z, eps_x, eps_z, coeffs, n_power, dtype)
        return self._estimator_moments(logdet, n_draws, train)

    def _estimator_moments(self, logdet, n_draws, train):
        """Keep a training estimate's telemetry (``implicit_block.py:975-981``)
        and return the estimate."""
        if train:
            est = logdet.detach()
            self.last_n_samples = n_draws.float()
            self.last_firmom = est.mean()[None]
            self.last_secmom = (est ** 2).mean()[None]
        return logdet

    def _fused_logdet(self, x, z, eps_x, eps_z, coeffs, n_power, dtype):
        """The training estimate of ``--mem-eff False`` (``implicit_block.py:
        923-965``): both nets' chains at ``dtype`` casts of the parameters,
        buffers, x, the re-attached z and the probes, then ``T_x - T_z`` of
        the final pair at the float32 effective tensors, x, z and probes."""
        cd_x = self.nnet_x.conv_chain_data(x.detach(), dtype)
        cd_z = self.nnet_z.conv_chain_data(z.detach(), dtype)
        acc_x, acc_z = ld.neumann_pair_accs(eps_x.to(dtype), cd_x, eps_z.to(dtype), cd_z,
                                            coeffs, n_power)
        data_x, data_z = self._forward_data()
        t_x, t_z = fused_final_pair(data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z,
                                    mode="bf16" if dtype == torch.bfloat16 else "f32")
        return t_x - t_z

    def _merged_forward_ok(self, x, draws, train):
        """The gate of the merged forward (``implicit_block.py:660-690``):
        training with draws on a 4-D input of the recipe conv stack, the
        Neumann gradient estimator without ``grad_in_forward``, one probe,
        no brute force (the port has no exact trace), ``IMNF_FUSED_BLOCK=1``
        and H*W >= ``IMNF_FUSED_SOLVE_MIN_HW``."""
        kc = kernel_config()
        return (kc.fused_block == "1" and train and draws is not None
                and x.ndim == 4 and x.shape[2] * x.shape[3] >= kc.fused_solve_min_hw
                and self.neumann_grad and not self.grad_in_forward
                and self.n_probes <= 1 and not self.brute_force and not self.generic())

    def _forward_merged(self, x, logpx, draws):
        """The merged path (``_forward_merged``, ``implicit_block.py:
        692-737``): the roulette and both probes first, the merged forward,
        then ``neumann_final`` of each net in the estimator dtype."""
        geom_p = torch.sigmoid(self.geom_p.detach())
        coeffs, n_power, n_draws = ld.sample_n_dist(
            draws, self.n_dist, self.n_samples, geom_p, self.lamb.detach(),
            self.n_exact_terms, self.series_cap, x.device)
        eps_x = draws.rademacher(x.shape, x.device)
        eps_z = draws.rademacher(x.shape, x.device)
        data_x, data_z = self._forward_data()
        z, self.solver_diag, acc_x, acc_z = _ImplicitForwardEstFunction.apply(
            self, x, eps_x, eps_z, ld.signed_coeffs(coeffs), n_power,
            *(data_x[k] for k in DATA_KEYS), *(data_z[k] for k in DATA_KEYS))
        dtype = torch.bfloat16 if kernel_config().bf16_est else torch.float32
        logdet = (ld.neumann_final(self.nnet_x, x.to(dtype), eps_x.to(dtype), acc_x)
                  - ld.neumann_final(self.nnet_z, z.to(dtype), eps_z.to(dtype), acc_z))
        return z, logpx - self._estimator_moments(logdet.float(), n_draws, True)

    def forward(self, x, logpx=None, draws=None, train=False):
        if logpx is not None and self._merged_forward_ok(x, draws, train):
            return self._forward_merged(x, logpx, draws)
        if train and self.generic():
            tx = self.nnet_x.lipschitz_tensors()
            z = _GenericImplicitFunction.apply(self, x, len(tx), *tx,
                                               *self.nnet_z.lipschitz_tensors())
        elif train:
            data_x, data_z = self._forward_data()
            z = _ImplicitFunction.apply(self, x, *(data_x[k] for k in DATA_KEYS),
                                        *(data_z[k] for k in DATA_KEYS))
        else:
            _, z, self.solver_diag = self.solve(x)
        if logpx is None:
            return z, None
        if draws is None:
            raise ValueError("stochastic logdet estimation requires draws")
        return z, logpx - self.logdetgrad(z, x, draws, train)

    @torch.no_grad()
    def inverse(self, z, logpz=None, draws=None):
        """(x, logpx): x solves ``x + g_x(x) = z + g_z(z)``
        (:meth:`solve_inverse`); with ``logpz``, ``logpz`` plus the
        evaluation estimator's log-det at (x, z) from ``draws``
        (``implicit_block.py:753-789``)."""
        x, _ = self.solve_inverse(z)
        if logpz is None:
            return x, None
        if draws is None:
            raise ValueError("stochastic logdet estimation requires draws")
        return x, logpz + self.logdetgrad(z, x, draws, train=False)

    @torch.no_grad()
    def update_lipschitz(self, n_iterations=None):
        """Power iteration of every conv after a step (``:985-990``)."""
        self.nnet_x.update_lipschitz(n_iterations)
        self.nnet_z.update_lipschitz(n_iterations)
