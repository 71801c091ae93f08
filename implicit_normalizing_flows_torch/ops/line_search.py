"""The Armijo line search of the fused Broyden solves with its CUDA kernel.

Port of the bounded two-trial backtracking inside the JAX package's solve
kernels (``ops/fused_solve.py::_broyden_in_kernel`` :610-642, and its
lane-packed twin ``_broyden_in_kernel_packed`` :373-405), which run in
``fused_broyden_solve`` (TPU kernel at ``fused_solve.py:1921``: forward and
inverse), ``fused_backward_solve`` (:930) and ``fused_block_forward``
(:1814) under ``IMNF_LINE_SEARCH=1``. Per live example, after the residual
``g1`` at the full step ``z1 = z + upd``:

1. ``phi0 = sum g^2`` at the current iterate, ``phi1 = sum g1^2``; the
   example fails the test when ``phi1 > phi0 (1 - c1)``, c1 = 1e-4;
2. a failing example tries the quadratic step ``sq = clip(phi0 / (2 phi1 +
   1e-30), 1e-2, 1)`` and takes it if ``phi_q <= phi0 (1 - c1 sq)``, else
   tries ``sh = sq / 2`` and takes it if ``phi_h <= phi0 (1 - c1 sh)``, else
   keeps the full step;
3. the secant update then takes the step actually taken, ``z_new - z``
   (``broyden_step``'s ``line_search``).

The TPU kernel evaluates both trials under one ``lax.cond`` per example;
on Hopper the solve's host loop runs the search as three device steps
around the residual evaluations, with no host read:

* ``PHASE_TEST`` on the active list: the test, and for each failing example
  the trial point ``ZQ = Z + sq UPD``, ``(phi0, sq)`` into ``lsf``, the
  example appended to ``fail``;
* the caller evaluates ``GQ`` at ``ZQ`` on the fail list;
* ``PHASE_HALF`` on the fail list: an example whose quadratic trial passes
  takes it into ``ZN`` / ``GN``; the others get the halved trial point
  ``ZH = Z + sh UPD``, ``lsf[:, 1] = sh``, and are appended to ``half``
  (skipping the halved evaluation of an example whose quadratic trial
  passed changes no result);
* the caller evaluates ``GH`` at ``ZH`` on the half list;
* ``PHASE_PICK`` on the half list: an example whose halved trial passes
  takes it into ``ZN`` / ``GN``; the others keep the full step.

``ls["tally"]`` counts, on the device, the examples that failed the test
and those that took the quadratic, the halved and the full step
(:func:`read_tally`).

:func:`line_search` launches the kernel (``csrc/line_search.cu``, linked
into ``fused_solve.cu``'s library; a thread-block cluster a live example on
:func:`~.fused_solve.broyden_plan`) for CUDA tensors and runs its plain
PyTorch version for CPU tensors; a CUDA tensor never falls back. It counts
its launches in ``line_search.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_solve import _check_aligned, _check_cuda, _launch, _ptr, broyden_plan

__all__ = ["line_search", "line_search_buffers", "read_tally", "reset_tally", "KERNELS",
           "launch_counts", "reset_launch_counts", "PHASE_TEST", "PHASE_HALF",
           "PHASE_PICK", "TALLY_KEYS"]

PHASE_TEST, PHASE_HALF, PHASE_PICK = 0, 1, 2
C1 = 1e-4      # the Armijo constant (reference scalar_search_armijo, broyden.py:24)
SQ_MIN = 1e-2  # the reference's amin
TALLY_KEYS = ("failed", "quadratic", "halved", "full")
_TALLIES: dict = {}  # device -> (4,) int32: TALLY_KEYS, summed over every search

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
             _I, _I, _I, _P]


def _lib():
    from . import cuda_build

    lib = cuda_build.load("fused_solve")
    if lib.imnf_line_search.argtypes is None:
        lib.imnf_line_search.argtypes = _ARGTYPES
        lib.imnf_line_search.restype = ctypes.c_int
    return lib


def _tally(dev):
    if dev not in _TALLIES:
        _TALLIES[dev] = torch.zeros(len(TALLY_KEYS), dtype=torch.int32, device=dev)
    return _TALLIES[dev]


def read_tally() -> dict:
    """{TALLY_KEYS: count} summed over every search on every device since
    :func:`reset_tally` (a host read)."""
    out = dict.fromkeys(TALLY_KEYS, 0)
    for t in _TALLIES.values():
        for k, v in zip(TALLY_KEYS, t.tolist()):
            out[k] += v
    return out


def reset_tally() -> None:
    for t in _TALLIES.values():
        t.zero_()


def line_search_buffers(B, D, dev):
    """The search's buffers for a solve of B examples of D elements: the
    trial points and residuals ``ZQ``, ``GQ``, ``ZH``, ``GH`` (B, D), ``lsf``
    (B, 2) = (phi0, the trial's step) per example, the fail and half lists
    (B,) int32 with their counts ``nfail`` / ``nhalf`` (views of ``counts``,
    (2,) int32) and the device's tally."""
    zeros = lambda *s, dt=torch.float32: torch.zeros(*s, device=dev, dtype=dt)
    counts = zeros(2, dt=torch.int32)
    ls = {k: zeros(B, D) for k in ("ZQ", "GQ", "ZH", "GH")}
    ls.update(lsf=zeros(B, 2), fail=zeros(B, dt=torch.int32), half=zeros(B, dt=torch.int32),
              counts=counts, nfail=counts[0:1], nhalf=counts[1:2], tally=_tally(dev))
    return ls


def _lists(phase, ls, idx, cnt):
    """(idx_in, cnt_in, idx_out, cnt_out) of ``phase``; PHASE_PICK appends
    to no list."""
    if phase == PHASE_TEST:
        return idx, cnt, ls["fail"], ls["nfail"]
    if phase == PHASE_HALF:
        return ls["fail"], ls["nfail"], ls["half"], ls["nhalf"]
    return ls["half"], ls["nhalf"], None, None


def _line_search_by(sumsq, phase, st, ls, idx=None, cnt=None):
    """``line_search``'s function with ``sumsq(v)`` (n, D) -> (n,) for its
    sums of squares; every other operation as the kernel rounds it."""
    idx_in, cnt_in, idx_out, cnt_out = _lists(phase, ls, idx, cnt)
    Z, UPD, ZN, GN = st["Z"], st["UPD"], st["ZN"], st["GN"]
    lsf, tally = ls["lsf"], ls["tally"]
    e = idx_in[:int(cnt_in.item())].long()
    if phase == PHASE_TEST:
        phi0, phi1 = sumsq(st["G"][e]), sumsq(GN[e])
        fail = phi1 > phi0 * (1.0 - C1)
        e, phi0, phi1 = e[fail], phi0[fail], phi1[fail]
        sq = torch.clamp(phi0 / (2.0 * phi1 + 1e-30), SQ_MIN, 1.0)
        ls["ZQ"][e] = Z[e] + sq[:, None] * UPD[e]
        lsf[e] = torch.stack([phi0, sq], 1)
        tally[0] += len(e)
    else:
        trial = "Q" if phase == PHASE_HALF else "H"
        phi0, step = lsf[e].unbind(1)
        ok = sumsq(ls["G" + trial][e]) <= phi0 * (1.0 - C1 * step)
        take = e[ok]
        ZN[take] = ls["Z" + trial][take]
        GN[take] = ls["G" + trial][take]
        tally[phase] += len(take)
        e, step = e[~ok], step[~ok]
        if phase == PHASE_PICK:
            tally[3] += len(e)
            return
        sh = step * 0.5
        ls["ZH"][e] = Z[e] + sh[:, None] * UPD[e]
        lsf[e, 1] = sh
    idx_out[:len(e)] = e.int()
    cnt_out.fill_(len(e))


def _sumsq_plain(v):
    return torch.sum(v * v, 1)


def _line_search_plain(phase, st, ls, idx=None, cnt=None):
    _line_search_by(_sumsq_plain, phase, st, ls, idx, cnt)


def line_search(phase, st, ls, idx=None, cnt=None):
    """One device step of the search (``phase``) for the examples of its
    list: PHASE_TEST on the active list ``idx`` / ``cnt`` (it zeroes both
    of ``ls``'s counts first), PHASE_HALF on ``ls["fail"]``, PHASE_PICK on
    ``ls["half"]``. ``st``: the solver state (``Z``, ``G``, ``UPD``, ``ZN``,
    ``GN``, of ``fused_solve._solve``); ``ls``: :func:`line_search_buffers`.
    On the card each live example runs on a thread-block cluster
    (:func:`~.fused_solve.broyden_plan`)."""
    if not st["Z"].is_cuda:
        return _line_search_plain(phase, st, ls, idx, cnt)
    B, D = st["Z"].shape
    plan = broyden_plan(D, 1)
    idx_in, cnt_in, idx_out, cnt_out = _lists(phase, ls, idx, cnt)
    vecs = {k: st[k] for k in ("Z", "G", "UPD", "ZN", "GN")}
    vecs.update({k: ls[k] for k in ("ZQ", "GQ", "ZH", "GH")})
    _check_cuda(idx_in=idx_in, cnt_in=cnt_in, idx_out=idx_out, cnt_out=cnt_out,
                lsf=ls["lsf"], tally=ls["tally"], counts=ls["counts"], **vecs)
    _check_aligned(**vecs)
    if any(tuple(v.shape) != (B, D) for v in vecs.values()) or tuple(ls["lsf"].shape) != (B, 2):
        raise ValueError("line_search: every vector (B, D) and lsf (B, 2), got "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in vecs.items()))
    if phase == PHASE_TEST:
        ls["counts"].zero_()
    _launch("imnf_line_search", phase, _ptr(idx_in), _ptr(cnt_in), _ptr(idx_out),
            _ptr(cnt_out), *(_ptr(v) for v in vecs.values()), _ptr(ls["lsf"]),
            _ptr(ls["tally"]), B, D, *plan, lib=_lib())
    line_search.launches += 1


KERNELS = {"line_search": line_search}
_PLAIN = {"line_search": _line_search_plain}
line_search.launches = 0


def launch_counts() -> dict:
    return {"line_search": line_search.launches}


def reset_launch_counts() -> None:
    line_search.launches = 0
