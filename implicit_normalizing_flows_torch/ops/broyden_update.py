"""The generic Broyden solver's rank-1 secant update with its CUDA kernel.

Port of ``ops/pallas_kernels.py::fused_broyden_update`` of the JAX package
(TPU kernel at ``pallas_kernels.py:69``, ``_kernel`` :27), which the JAX
solver runs under ``IMNF_PALLAS=1`` in place of its XLA formulas
(``broyden.py:294-312``). With the inverse Jacobian approximated as
``-I + U V^T`` (``Us`` (B, D, K), ``VTs`` (B, K, D)), one iteration's step
``delta_x`` and residual change ``delta_gx`` append the pair

    vT = rmatvec(delta_x),  u = (delta_x - matvec(delta_gx)) / (vT . delta_gx)

at column ``col`` (NaN and inf scrubbed to 0, 0 on inactive examples) and
return the next direction ``-matvec(U', V', gx)`` through the rank-1 identity
``matvec(U', V', gx) = matvec(U, V, gx) + u (vT . gx)``.

Unlike the JAX function, which returns new factors, this one writes column
``col`` of ``Us`` and row ``col`` of ``VTs`` in place and returns the
direction: the solver writes column ``nstep - 1`` and stops at ``nstep =
K``, so the columns ``>= col`` are still zero and only ``< col`` are read.

:func:`broyden_update` launches ``csrc/broyden_update.cu`` (that file's
header says what bounds it on an H100) for CUDA tensors and runs
:func:`broyden_update_plain` for CPU tensors; a CUDA tensor never falls
back. It counts its launches in ``broyden_update.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_solve import _check_cuda, _launch, _ptr
from .implicit_grad import _shapes

__all__ = ["broyden_update", "broyden_update_plain", "KERNELS", "launch_counts",
           "reset_launch_counts"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
MAX_K = 4000  # the kernel's 3 * col per-column sums stay under 48 KB of shared memory


def _lib():
    from . import cuda_build

    lib = cuda_build.load("broyden_update")
    f = lib.imnf_broyden_update
    if f.argtypes is None:
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int
    return lib


def broyden_update_plain(Us, VTs, delta_x, delta_gx, gx, active, col):
    """The XLA path's formulas (``broyden.py:294-312``) on the live columns
    ``< col``, any device and float dtype; writes column ``col`` in place
    and returns the direction."""
    Ul, Vl = Us[:, :, :col], VTs[:, :col, :]
    vtx = torch.einsum("bkd,bdr->bkr", Vl, torch.stack([delta_gx, gx], dim=-1))
    uvx = torch.einsum("bdk,bkr->bdr", Ul, vtx)
    matvec_dgx = -delta_gx + uvx[..., 0]
    matvec_gx = -gx + uvx[..., 1]
    xtu = torch.einsum("bd,bdk->bk", delta_x, Ul)
    vT = -delta_x + torch.einsum("bk,bkd->bd", xtu, Vl)
    denom = torch.einsum("bd,bd->b", vT, delta_gx)[:, None]
    u = (delta_x - matvec_dgx) / denom
    act = active[:, None]
    vT = torch.where(act & torch.isfinite(vT), vT, 0.0)
    u = torch.where(act & torch.isfinite(u), u, 0.0)
    Us[:, :, col] = u
    VTs[:, col, :] = vT
    return -matvec_gx - u * torch.einsum("bd,bd->b", vT, gx)[:, None]


def broyden_update(Us, VTs, delta_x, delta_gx, gx, active, col):
    """Append the secant pair at column ``col`` of ``Us`` (B, D, K) and row
    ``col`` of ``VTs`` (B, K, D), in place, and return the next direction
    (B, D). ``delta_x``, ``delta_gx``, ``gx`` (B, D); ``active`` (B,) bool;
    ``col`` a host int with the columns ``>= col`` zero. CUDA tensors
    (float32, contiguous) run the kernel, CPU tensors the plain version."""
    if not Us.is_cuda:
        return broyden_update_plain(Us, VTs, delta_x, delta_gx, gx, active, col)
    B, D, K = Us.shape
    _check_cuda(_dtypes=(torch.float32,), Us=Us, VTs=VTs, delta_x=delta_x,
                delta_gx=delta_gx, gx=gx)
    _check_cuda(_dtypes=(torch.bool,), active=active)
    if active.device != Us.device:
        raise ValueError(f"active: on {active.device}, other operands on {Us.device}")
    _shapes(VTs=(VTs, (B, K, D)), delta_x=(delta_x, (B, D)), delta_gx=(delta_gx, (B, D)),
            gx=(gx, (B, D)), active=(active, (B,)))
    if not 0 <= col < K or K > MAX_K:
        raise ValueError(f"column {col} of {K} (at most {MAX_K} columns)")
    update = torch.empty_like(gx)
    _launch("imnf_broyden_update", _ptr(Us), _ptr(VTs), _ptr(delta_x), _ptr(delta_gx),
            _ptr(gx), _ptr(active), B, D, K, int(col), _ptr(update), lib=_lib())
    broyden_update.launches += 1
    return update


broyden_update.launches = 0
KERNELS = {"broyden_update": broyden_update}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
