"""The generic Broyden solver's rank-1 secant update with its CUDA kernel.

Port of ``ops/pallas_kernels.py::fused_broyden_update`` of the JAX package
(TPU kernel at ``pallas_kernels.py:69``, ``_kernel`` :27), which the JAX
solver runs under ``IMNF_PALLAS=1`` in place of its XLA formulas
(``broyden.py:294-312``). With the inverse Jacobian approximated as
``-I + U V^T``, one iteration's step ``delta_x`` and residual change
``delta_gx`` append the pair

    vT = rmatvec(delta_x),  u = (delta_x - matvec(delta_gx)) / (vT . delta_gx)

at plane ``col`` (NaN and inf scrubbed to 0, 0 on inactive examples) and
return the next direction ``-matvec(U', V', gx)`` through the rank-1 identity
``matvec(U', V', gx) = matvec(U, V, gx) + u (vT . gx)``.

Both panels are plane-major here: ``UTs`` (B, K, D) holds U's columns as
rows, as ``VTs`` (B, K, D) holds V's, so an example's live planes are one
contiguous block of each (the JAX solver's ``Us`` is (B, D, K): its
transpose). Unlike the JAX function, which returns new factors, this one
writes plane ``col`` of ``UTs`` and ``VTs`` in place and returns the
direction: the solver writes plane ``nstep - 1`` and stops at ``nstep =
K``, so the planes ``>= col`` are still zero and only ``< col`` are read.

:func:`broyden_update` launches ``csrc/broyden_update.cu`` (that file's
header says what bounds it on an H100 and how its two forms meet it; the
shape picks the form, :func:`update_plan`) for CUDA tensors and runs
:func:`broyden_update_plain` for CPU tensors; a CUDA tensor never falls
back. It counts its launches in ``broyden_update.launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .fused_solve import _PlainSums, _check_cuda, _launch, _ptr
from .implicit_grad import _shapes

__all__ = ["broyden_update", "broyden_update_plain", "update_plan", "UpdatePlan", "KERNELS",
           "launch_counts", "reset_launch_counts"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P]

CLUSTERS = (8, 4, 2, 1)  # the cluster form's CTAs an example, the larger first
VPT = (1, 2, 4)  # the kernel's instantiations: float4 vectors a thread, elements a lane
MAX_THREADS = 256  # a cluster-form CTA's threads at most
WARP_EXAMPLES = 4  # the warp form's examples (warps) a CTA
WARP_MAX_D = 32 * VPT[-1]  # the widest D of the warp form
REG_MAX_D = CLUSTERS[0] * MAX_THREADS * VPT[-1] * 4  # the widest D held in registers


class UpdatePlan(NamedTuple):
    """How ``csrc/broyden_update.cu`` cuts one example's D elements.
    ``cluster`` 0: the warp form, a warp an example (``threads`` a CTA,
    ``WARP_EXAMPLES`` examples), lane l the elements l + 32 m, m < ``vpt``.
    Else the cluster form: ``cluster`` CTAs an example, CTA r the float4
    vectors [r slice, (r + 1) slice) of the example's rows (the last CTA
    may hold fewer), thread t of ``threads`` the vectors t + m threads, m <
    ``vpt`` (held in registers where ``vpt`` is in VPT, else walked by the
    stream kernel)."""
    cluster: int
    slice: int
    threads: int
    vpt: int


def update_plan(D):
    """:class:`UpdatePlan` of ``broyden_update`` at D elements an example:
    the warp form up to WARP_MAX_D, with the fewest elements a lane; above
    it the largest cluster of CLUSTERS that leaves each CTA at least a
    warp's vectors (one CTA where none does), and the fewest vectors a
    thread (VPT) that keep a CTA at most MAX_THREADS threads (a multiple of
    32); past REG_MAX_D MAX_THREADS threads and as many vectors a thread as
    it takes (the stream kernel). Raises on D < 1."""
    if D < 1:
        raise ValueError(f"broyden_update takes D >= 1, not D {D}")
    if D <= WARP_MAX_D:
        return UpdatePlan(0, 0, 32 * WARP_EXAMPLES, next(v for v in VPT if D <= 32 * v))
    nvec = -(-D // 4)
    cluster = next((c for c in CLUSTERS if nvec >= 32 * c), 1)
    slice_ = -(-nvec // cluster)
    vpt = next((v for v in VPT if -(-slice_ // v) <= MAX_THREADS), -(-slice_ // MAX_THREADS))
    return UpdatePlan(cluster, slice_, (-(-slice_ // vpt) + 31) // 32 * 32, vpt)


def _lib():
    from . import cuda_build

    lib = cuda_build.load("broyden_update")
    f = lib.imnf_broyden_update
    if f.argtypes is None:
        f.argtypes, f.restype = _ARGTYPES, ctypes.c_int
    return lib


def _broyden_update_by(sums, UTs, VTs, delta_x, delta_gx, gx, active, col):
    """``broyden_update``'s function with ``sums`` (the methods of
    ``fused_solve._PlainSums``) for its contractions over D, its
    combinations over k and its two dot products; every other operation as
    the plain version rounds it. Writes plane ``col`` in place and returns
    the direction."""
    Ul, Vl = UTs[:, :col], VTs[:, :col]
    live = torch.ones(Ul.shape[:2], dtype=torch.bool, device=Ul.device)
    vtx, vtg, xtu = (sums.contract(p, v, live)
                     for p, v in ((Vl, delta_gx), (Vl, gx), (Ul, delta_x)))
    matvec_dgx = -delta_gx + sums.combine(vtx, Ul, live)
    matvec_gx = -gx + sums.combine(vtg, Ul, live)
    vT = -delta_x + sums.combine(xtu, Vl, live)
    u = (delta_x - matvec_dgx) / sums.dot(vT, delta_gx)
    act = active[:, None]
    vT = torch.where(act & torch.isfinite(vT), vT, 0.0)
    u = torch.where(act & torch.isfinite(u), u, 0.0)
    UTs[:, col] = u
    VTs[:, col] = vT
    return -matvec_gx - u * sums.dot(vT, gx)


def broyden_update_plain(UTs, VTs, delta_x, delta_gx, gx, active, col):
    """The XLA path's formulas (``broyden.py:294-312``) on the live planes
    ``< col``, any device and float dtype; writes plane ``col`` in place
    and returns the direction."""
    return _broyden_update_by(_PlainSums, UTs, VTs, delta_x, delta_gx, gx, active, col)


def broyden_update(UTs, VTs, delta_x, delta_gx, gx, active, col):
    """Append the secant pair at plane ``col`` of ``UTs`` and ``VTs`` (B, K,
    D), in place, and return the next direction (B, D). ``delta_x``,
    ``delta_gx``, ``gx`` (B, D); ``active`` (B,) bool; ``col`` a host int
    with the planes ``>= col`` zero. CUDA tensors (float32, contiguous) run
    the kernel in the form :func:`update_plan` picks, CPU tensors the plain
    version."""
    if not UTs.is_cuda:
        return broyden_update_plain(UTs, VTs, delta_x, delta_gx, gx, active, col)
    B, K, D = UTs.shape
    _check_cuda(_dtypes=(torch.float32,), UTs=UTs, VTs=VTs, delta_x=delta_x,
                delta_gx=delta_gx, gx=gx)
    _check_cuda(_dtypes=(torch.bool,), active=active)
    if active.device != UTs.device:
        raise ValueError(f"active: on {active.device}, other operands on {UTs.device}")
    _shapes(VTs=(VTs, (B, K, D)), delta_x=(delta_x, (B, D)), delta_gx=(delta_gx, (B, D)),
            gx=(gx, (B, D)), active=(active, (B,)))
    if not 0 <= col < K:
        raise ValueError(f"plane {col} of {K}")
    plan = update_plan(D)
    update = torch.empty_like(gx)
    # float4 loads where every row starts on 16 bytes
    vec4 = D % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (UTs, VTs, delta_x, delta_gx, gx, update))
    _launch("imnf_broyden_update", _ptr(UTs), _ptr(VTs), _ptr(delta_x), _ptr(delta_gx),
            _ptr(gx), _ptr(active), B, D, K, int(col), _ptr(update), *plan, int(vec4),
            lib=_lib())
    broyden_update.launches += 1
    return update


broyden_update.launches = 0
KERNELS = {"broyden_update": broyden_update}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
