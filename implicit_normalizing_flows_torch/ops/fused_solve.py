"""Forward Broyden solve ``z : x + g_x(x) = z + g_z(z)`` with its CUDA kernels.

Port of ``ops/fused_solve.py::fused_broyden_solve`` / ``_solve_kernel`` of
the JAX package (TPU kernel at ``fused_solve.py:1921``). The TPU kernel keeps
one example's whole solve in VMEM; on Hopper the solve is a host-driven loop
over four batched kernels of ``csrc/fused_solve.cu`` (that file's header
says what bounds each on an H100 and what its design does about it):

* ``conv3x3_in``  ``[swish(b0)] -> conv3x3 c->mid + b1 -> swish(b1)`` (modes
  ``tf32`` / ``tf32x`` on the tensor cores, ``csrc/conv3x3_in_tc.cuh``)
* ``conv1x1_mid`` ``mid->mid + b2 -> swish(b2)`` (modes ``tf32`` / ``tf32x``
  on the tensor cores, ``csrc/mma_gemm.cuh``)
* ``conv3x3_out`` ``conv3x3 mid->c + b3`` fused with the residual (modes
  ``tf32`` / ``tf32x`` on the tensor cores, ``csrc/conv3x3_out_tc.cuh``)
* ``broyden_step`` secant update, best iterate, protective break, stall
  exit, next direction (also the init and the ladder's re-arm); its own
  unit ``csrc/broyden_step.cu``, a thread-block cluster a live example
  (:func:`broyden_plan`)

Every launch works on a device-resident list of active example indices, so
an example that is done costs no further work (per-example early exit).
The host reads one count per iteration (the number of still-active
examples) to decide whether to go on.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; a CUDA tensor never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
:func:`fused_broyden_solve_plain` is the whole solve with the plain versions
forced, on any device: the CPU tests and the card's check compare against it.

Semantics kept per example (``_broyden_in_kernel``, ``fused_solve.py:538``):
warm start, Newton first step, best-iterate return with the residual at the
best iterate, tolerance ``eps * sqrt(D)`` on the true D, protective break at
1e6x the initial objective, stall exit (patience, rtol, guard), NaN scrub,
and the precision ladder (``:725-770``): at each stage start, re-arm the
still-unconverged, unbroken examples from their best iterate, with
``x_embed`` and the residual re-evaluated at the stage precision and the
secant planes kept. Under ``line_search`` (``IMNF_LINE_SEARCH=1``) every
iteration of every stage runs the Armijo search of ``ops/line_search.py``
(``:610-642``) after its residual, and the secant update takes the step
taken, ``ZN - Z``. The TPU lane packing (``reps``) and K-packing are tile
devices, not semantics, and are not ported.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["fused_broyden_solve", "fused_broyden_solve_plain",
           "FusedSolveResult", "conv3x3_in", "conv1x1_mid", "conv3x3_out",
           "broyden_step", "broyden_plan", "StepPlan", "KERNELS", "solve_ops", "launch_counts",
           "reset_launch_counts",
           "prep_weight", "prep_weights", "prep_conv1x1_mid", "check_mid_product",
           "check_conv3x3_tc", "conv3x3_in_rows", "conv3x3_in_smem", "C3_OUT_ROWS",
           "prep_conv3x3_out", "conv3x3_out_smem", "C3_SOLVE_GROUPS", "c3_out_npad",
           "tile_w1t", "untile_w1t", "norm_ladder",
           "swish", "dswish", "dswish_dbeta", "d2swish", "ddswish_dbeta"]

PROTECT_THRES = 1e6  # reference: broyden.py:150
MODES = {"f32": 0, "bf16": 1, "tf32": 2, "tf32x": 3}
PHASE_INIT, PHASE_STEP, PHASE_REARM = 0, 1, 2
KMAX = 64  # largest threshold broyden_step takes (its shared-memory rows)
TC_KMAX = 512  # the largest K the tensor-core 1x1 product takes (csrc/mma_gemm.cuh)
SPLIT_MODES = ("tf32", "tf32x")  # the solve's conv kernels' modes on the tensor cores
TC_SMEM_MAX = 232448  # the dynamic shared memory an SM grants a block (csrc/mma_gemm.cuh)


class FusedSolveResult(NamedTuple):
    result: torch.Tensor      # (B, c, H, W) best iterate
    gx: torch.Tensor          # (B, c, H, W) residual at the best iterate
    nstep: torch.Tensor       # (B,) int32 per-example iterations
    diff: torch.Tensor        # (B,) best objective
    prot_break: torch.Tensor  # (B,) bool
    converged: torch.Tensor   # (B,) bool


def norm_ladder(threshold, tail_mode, tail_start):
    """(modes, starts) of the precision ladder (``_norm_ladder``,
    ``fused_solve.py:205-233``): threshold 30, start 15 -> (15, 22)."""
    if tail_mode is None:
        return (), ()
    modes = tuple(m for m in (tail_mode.split(",") if isinstance(tail_mode, str)
                              else tail_mode) if m)
    if not modes:
        return (), ()
    if isinstance(tail_start, (tuple, list)):
        if len(tail_start) != len(modes):
            raise ValueError("tail_start tuple must match tail_mode stages")
        return modes, tuple(min(int(v), threshold) for v in tail_start)
    s = threshold // 2 if tail_start is None else int(tail_start)
    starts = []
    for _ in modes:
        starts.append(min(int(s), threshold))
        s = s + max(1, (threshold - s) // 2)
    return modes, tuple(starts)


def swish(t, beta):
    """The solve kernel's swish (``fused_solve.py:236-237``): multiplies by
    f32(1/1.1), as the CUDA epilogues do."""
    return t * torch.sigmoid(t * beta) * (1.0 / 1.1)


def _wide(dtype):
    """float32, or float64 for float64 tensors (the float64 checks)."""
    return torch.promote_types(dtype, torch.float32)


def dswish(t, beta):
    """d/dt of :func:`swish` as the JAX kernels write it (``_dswish``,
    ``fused_solve.py:240-242``), in float32 (float64 for float64 t)."""
    dt = _wide(t.dtype)
    t, beta = t.to(dt), torch.as_tensor(beta, dtype=dt, device=t.device)
    s = torch.sigmoid(t * beta)
    return (s + t * beta * s * (1.0 - s)) * (1.0 / 1.1)


def dswish_dbeta(t, beta):
    """d/dbeta of :func:`swish` (``_dswish_dbeta``, ``fused_solve.py:1068``)."""
    s = torch.sigmoid(t * beta)
    return t * t * s * (1.0 - s) * (1.0 / 1.1)


def d2swish(t, beta):
    """d^2/dt^2 of :func:`swish` (``_d2swish``, ``fused_solve.py:1073``), in
    the JAX kernel's order with a float32 slope."""
    beta = torch.as_tensor(beta, dtype=t.dtype, device=t.device)
    s = torch.sigmoid(t * beta)
    sp = s * (1.0 - s)
    return (2.0 * beta * sp + beta * beta * t * (1.0 - 2.0 * s) * sp) * (1.0 / 1.1)


def ddswish_dbeta(t, beta):
    """d/dbeta of :func:`dswish` (``_ddswish_dbeta``, ``fused_solve.py:1080``)."""
    beta = torch.as_tensor(beta, dtype=t.dtype, device=t.device)
    s = torch.sigmoid(t * beta)
    sp = s * (1.0 - s)
    return (2.0 * t * sp + beta * t * t * (1.0 - 2.0 * s) * sp) * (1.0 / 1.1)


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _split(a, mode):
    """(hi, lo) bf16 round-to-nearest split (``_split_hi_lo``); lo is None
    for the single-pass modes."""
    if mode == "f32":
        return a, None
    hi = _bf16(a)
    return hi, (_bf16(a - hi) if mode in ("tf32", "tf32x") else None)


def prep_weight(w, mode):
    """Weight-side precision prep (``_make_wdot``): ``(hi, lo)`` of one
    kernel in its OIHW layout, lo None for the single-pass modes."""
    w = w.detach().to(_wide(w.dtype))
    return tuple(None if t is None else t.contiguous() for t in _split(w, mode))


def prep_conv1x1_mid(wp, mode):
    """``conv1x1_mid``'s kernel from :func:`prep_weight`'s ``(hi, lo)``: in
    the split modes both halves cast once to bfloat16 (exactly: their
    values are bfloat16), the tensor cores' operands; modes f32 and bf16
    keep ``wp`` (float32, the CUDA cores). The merged forward's
    ``lin_conv3x3_in`` takes w1's pair so prepared, in its (mid, c, 3, 3)
    layout, and so does the solve's ``conv3x3_in`` (:func:`prep_weights`'
    ``w1_in``)."""
    if mode not in SPLIT_MODES:
        return wp
    return tuple(w.to(torch.bfloat16).contiguous() for w in wp)


C3_CMAX = 48  # the largest c the tensor-core 3x3 kernels take
C3_MID = 64  # their mid channels come in multiples of this
C3_OUT_ROWS = 8  # the image rows of a band of the mid -> c kernel (csrc/conv3x3_out_tc.cuh)
# the blocks a band's output tiles are split over in the mid -> c kernel's
# split form (conv3x3_out in tf32 / tf32x), by c3_out_npad(c): 1, 2 and 2
# tiles of 8 channels a block (on an H100 c 12 at 16x16 in two blocks of
# one tile, and c 48 at 8x8 in six, were slower)
C3_SOLVE_GROUPS = {8: 1, 16: 1, 48: 3}


# A mid -> c kernel in the tensor-core kernel's tile layout
# (csrc/conv3x3_out_tc.cuh): the chain's and the final pair's W1T, the
# solve's W3

def c3_out_npad(c):
    """The output-channel rows of a tap in the mid -> c kernel's weight tile:
    c padded to 8, 16 or 48 (its 1, 2 or 6 tiles of 8 channels), or past 48
    (which the kernel refuses) to a multiple of 8."""
    return next((n for n in (8, 16, 48) if c <= n), -(-c // 8) * 8)


def tile_w1t(w1t):
    """W1T (N, c, mid, 3, 3), or any N mid -> c kernels, in the mid -> c
    kernel's tile layout, cast to bfloat16 (exactly, for bfloat16 values):
    (N, mid / 64, 9 npad, 64), for each net and chunk of 64 mid channels m0
    .. m0 + 63 the rows tap * npad + co (tap = ky * 3 + kx, npad
    :func:`c3_out_npad`) of 128 bytes, zero past c; mid is padded with zero
    channels to a multiple of 64. A block copies a chunk's rows into shared
    memory with 16-byte copies, no conversion."""
    N, c, mid = w1t.shape[:3]
    mc = C3_MID
    nch = -(-mid // mc)
    w = torch.nn.functional.pad(w1t.reshape(N, c, mid, 9), (0, 0, 0, nch * mc - mid))
    w = w.reshape(N, c, nch, mc, 9).permute(0, 2, 4, 1, 3)  # (N, chunk, tap, co, ch)
    w = torch.nn.functional.pad(w, (0, 0, 0, c3_out_npad(c) - c))
    return w.reshape(N, nch, -1, mc).to(torch.bfloat16).contiguous()


def untile_w1t(w, c, mid):
    """:func:`tile_w1t`'s W1T back in OIHW (N, c, mid, 3, 3), float32; a
    W1T already in OIHW is returned as it is."""
    if w.dim() != 4:
        return w
    N, nch, rows, mc = w.shape
    w = w.float().reshape(N, nch, 9, rows // 9, mc)[:, :, :, :c]  # (N, chunk, tap, co, ch)
    return w.permute(0, 3, 1, 4, 2).reshape(N, c, nch * mc, 3, 3)[:, :, :mid].contiguous()


def prep_conv3x3_out(wp, mode):
    """``conv3x3_out``'s kernel from :func:`prep_weight`'s ``(hi, lo)`` of
    W3 (c, mid, 3, 3): in the split modes both halves in the mid -> c
    kernel's tile layout (:func:`tile_w1t`, bfloat16, exactly: their values
    are bfloat16), the tensor cores' operands; modes f32 and bf16 keep
    ``wp`` (float32 OIHW, the CUDA cores)."""
    if mode not in SPLIT_MODES:
        return wp
    return tuple(tile_w1t(w[None])[0] for w in wp)


def conv3x3_out_smem(c, W):
    """The shared memory of a block of the mid -> c kernel's split form
    (``c3_smem_bytes(TW, NT, 2, 2)``, ``csrc/conv3x3_out_tc.cuh``): its hi
    and lo halo tiles, one buffer of a chunk's weights in both halves for
    the block's NT output tiles, 128 bytes of slack."""
    npad = c3_out_npad(c)
    nt = npad // 8 // C3_SOLVE_GROUPS[npad]
    return 2 * (C3_OUT_ROWS + 2) * (W + 2) * 128 + 2 * 9 * 8 * nt * 128 + 128


def conv3x3_in_rows(W):
    """The image rows of a band of the c -> mid kernel
    (``csrc/conv3x3_in_tc.cuh``): 128 pixels, 64 at W 8."""
    return (64 if W == 8 else 128) // W


def conv3x3_in_smem(c, W, panels):
    """The shared memory of a block of the c -> mid kernel with ``panels``
    im2col tiles (1 in mode bf16, 2 in the split modes): its halo tile, k
    offsets and tiles (``c3i_smem_bytes``, ``csrc/conv3x3_in_tc.cuh``)."""
    up = lambda v, m: -(-v // m) * m
    npx, kpad = (64 if W == 8 else 128), up(9 * c, 16)
    halo = up(c * (npx // W + 2) * (W + 2) * 4, 128)
    return halo + up(kpad * 4, 128) + panels * npx * ((kpad // 8) | 1) * 16 + 128


def check_conv3x3_tc(name, c, mid, H, W, rows, panels=None, split_out=False, **aligned):
    """Raise on what a tensor-core 3x3 kernel between c and mid channels
    (``csrc/conv3x3_in_tc.cuh``, c -> mid; ``csrc/conv3x3_out_tc.cuh``, mid
    -> c) does not take: c over C3_CMAX, mid not a multiple of C3_MID, W
    other than 8, 16 or 32, H not a multiple of the kernel's band of
    ``rows`` image rows, or a tensor of ``aligned`` not 16-byte aligned;
    with ``panels`` (the c -> mid kernel's im2col tiles) also tiles that
    outgrow the shared memory an SM grants (the split modes' two at c 48
    and W over 8), and with ``split_out`` the mid -> c kernel's split tiles
    (:func:`conv3x3_out_smem`) that would."""
    if c > C3_CMAX or mid % C3_MID or W not in (8, 16, 32) or H % rows:
        raise ValueError(f"{name} on the tensor cores takes c <= {C3_CMAX}, mid % {C3_MID} "
                         f"== 0, W 8 | 16 | 32 and H % {rows} == 0, not c {c}, mid {mid}, "
                         f"H {H}, W {W}")
    smem = (conv3x3_in_smem(c, W, panels) if panels is not None
            else conv3x3_out_smem(c, W) if split_out else 0)
    if smem > TC_SMEM_MAX:
        tiles = f"{panels} im2col tiles" if panels is not None else "split halo tiles"
        raise ValueError(f"{name} on the tensor cores takes no c {c} at W {W} with {tiles}: "
                         f"{smem} bytes of shared memory a block, over {TC_SMEM_MAX}")
    _check_aligned(**aligned)


def prep_weights(data, mode):
    """:func:`prep_weight` of ``data``'s w1/w2/w3, once per solve and mode:
    ``{'w1'|'w2'|'w3': (hi, lo)}``, and as the tensor-core kernels take them
    in the split modes: ``'w1_in'``, w1's for ``conv3x3_in`` and the merged
    forward's ``lin_conv3x3_in``, ``'w2_mid'``, w2's for ``conv1x1_mid`` and
    ``lin_conv1x1_mid`` (:func:`prep_conv1x1_mid`), and ``'w3_tc'``, w3's
    for ``conv3x3_out`` (:func:`prep_conv3x3_out`)."""
    out = {k: prep_weight(data[k], mode) for k in ("w1", "w2", "w3")}
    out["w1_in"] = prep_conv1x1_mid(out["w1"], mode)
    out["w2_mid"] = prep_conv1x1_mid(out["w2"], mode)
    out["w3_tc"] = prep_conv3x3_out(out["w3"], mode)
    return out


def _widened(wp):
    """A kernel pair as the plain versions take it: bfloat16 halves widened
    to float32, exactly."""
    return tuple(w.float() if w is not None and w.dtype == torch.bfloat16 else w
                 for w in wp)


def _mconv(x, wp, mode, padding):
    """conv2d at the precision model: f32, or hi*hi + hi*lo + lo*hi
    (+ lo*lo) on the bf16 split with f32 accumulation."""
    w_hi, w_lo = wp
    if mode == "f32":
        return F.conv2d(x, w_hi, padding=padding)
    x_hi, x_lo = _split(x, mode)
    out = F.conv2d(x_hi, w_hi, padding=padding)
    if mode in ("tf32", "tf32x"):
        out = out + F.conv2d(x_hi, w_lo, padding=padding)
        out = out + F.conv2d(x_lo, w_hi, padding=padding)
        if mode == "tf32x":
            out = out + F.conv2d(x_lo, w_lo, padding=padding)
    return out


# ---------------------------------------------------------------------------
# the library

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "imnf_conv3x3_in": [_I, _I, _P, _P, _P, _F, _F, _P, _P, _P, _I, _I, _I,
                        _I, _I, _P, _P],
    "imnf_conv1x1_mid": [_I, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P, _P],
    "imnf_conv3x3_out": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                         _F, _P, _P, _I, _P],
    "imnf_broyden_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _F, _I, _I, _I, _I,
                          _I, _I, _P],
}


def _lib():
    from . import cuda_build

    lib = cuda_build.load("fused_solve")
    for fn, args in _ARGTYPES.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(_dtypes=(torch.float32, torch.int32), **tensors):
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: on {t.device}, other operands on {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.dtype not in _dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} not taken")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def _launch(fn, *args, lib=None):
    rc = getattr(lib or _lib(), fn)(*args, _ptr_stream())
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _ptr_stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# the four kernels' wrappers. Active-list convention: idx (B,) int32 holds
# example indices, count (1,) int32 how many of them are live; the nets'
# intermediates t1/t2 (B, mid, HW) are indexed by slot (position in idx).

def _conv3x3_in_by(product, inp, idx, count, wp, b1, betas, preact, mode, out):
    """``conv3x3_in``'s function with ``product(h, wp, mode)`` for its 3x3
    product (the gather, swish before it and b1 and swish after it, as the
    kernels take them)."""
    n = int(count.item())
    B, c, H, W = inp.shape
    h = inp.index_select(0, idx[:n].long())
    if preact:
        h = swish(h, betas[0])
    y = swish(product(h, wp, mode) + b1[None, :, None, None], betas[1])
    out[:n] = y.flatten(2)


def _conv3x3_in_plain(inp, idx, count, wp, b1, betas, preact, mode, out):
    _conv3x3_in_by(lambda h, w, m: _mconv(h, _widened(w), m, 1), inp, idx, count, wp, b1,
                   betas, preact, mode, out)


def conv3x3_in(inp, idx, count, wp, b1, betas, preact, mode, out):
    """out[s] = swish(conv3x3([swish](inp[idx[s]])) + b1, beta1) for live
    slots s; the dead slots of out are not written. inp (B, c, H, W); out
    (B, mid, H*W); betas (3,) host floats or a tensor. wp = (w_hi, w_lo) of
    the (mid, c, 3, 3) kernel from :func:`prep_conv1x1_mid`: in the split
    modes, which run on the tensor cores (``csrc/conv3x3_in_tc.cuh``;
    ``tc_launches`` counts those launches), bfloat16 halves, with what
    :func:`check_conv3x3_tc` asks of the shapes and two im2col tiles within
    an SM's shared memory, and a 16-byte aligned out; float32 in modes f32
    / bf16 (the CUDA cores)."""
    if not inp.is_cuda:
        return _conv3x3_in_plain(inp, idx, count, wp, b1, betas, preact, mode, out)
    B, c, H, W = inp.shape
    mid = wp[0].shape[0]
    split = mode in SPLIT_MODES
    _check_cuda(inp=inp, idx=idx, count=count, b1=b1, out=out)
    _check_cuda(_dtypes=(torch.bfloat16 if split else torch.float32,), w_hi=wp[0],
                w_lo=wp[1])
    if tuple(wp[0].shape) != (mid, c, 3, 3) or tuple(out.shape) != (B, mid, H * W):
        raise ValueError(f"conv3x3_in: inp {tuple(inp.shape)}, w {tuple(wp[0].shape)}, "
                         f"out {tuple(out.shape)}")
    if split:
        if wp[1] is None:
            raise ValueError(f"conv3x3_in in {mode} takes both halves of the split")
        check_conv3x3_tc("conv3x3_in", c, mid, H, W, conv3x3_in_rows(W), panels=2, out=out)
    b = [float(v) for v in betas]
    _launch("imnf_conv3x3_in", MODES[mode], int(preact), _ptr(wp[0]),
            _ptr(wp[1]), _ptr(b1), b[0], b[1], _ptr(inp), _ptr(idx),
            _ptr(count), B, c, H, W, mid, _ptr(out))
    conv3x3_in.launches += 1
    if split:
        conv3x3_in.tc_launches += 1


def _conv1x1_mid_plain(t1, count, wp, b2, beta2, mode, out, H, W):
    n = int(count.item())
    mid = t1.shape[1]
    h = t1[:n].reshape(n, mid, H, W)
    y = swish(_mconv(h, _widened(wp), mode, 0) + b2[None, :, None, None], beta2)
    out[:n] = y.reshape(n, mid, H * W)


def check_mid_product(name, t1, wp, mode, **tensors):
    """Raise on what the forward 1x1 kernels (``conv1x1_mid``, the merged
    forward's ``lin_conv1x1_mid``) do not take: CUDA, contiguous float32
    ``tensors`` (int32 ``count``), those other than ``count`` and ``b2`` in
    t1's shape; wp from
    :func:`prep_conv1x1_mid`, bfloat16 halves in the split modes (the tensor
    cores: mid <= TC_KMAX with mid % 8 == 0, H*W % 4 == 0, both halves and
    16-byte aligned tensors), float32 in modes f32 / bf16. Returns whether
    the split modes' tensor-core kernel runs."""
    B, mid, HW = t1.shape
    split = mode in SPLIT_MODES
    _check_cuda(t1=t1, **tensors)
    _check_cuda(_dtypes=(torch.bfloat16 if split else torch.float32,), w_hi=wp[0],
                w_lo=wp[1])
    outs = {k: t for k, t in tensors.items() if k not in ("count", "b2")}
    if (any(tuple(t.shape) != (B, mid, HW) for t in outs.values())
            or tuple(wp[0].shape) != (mid, mid, 1, 1)):
        raise ValueError(f"{name}: t1 {tuple(t1.shape)}, w {tuple(wp[0].shape)}, "
                         + ", ".join(f"{k} {tuple(t.shape)}" for k, t in outs.items()))
    if split:
        if mid > TC_KMAX or mid % 8 or HW % 4 or wp[1] is None:
            raise ValueError(f"{name} in {mode} takes mid <= {TC_KMAX} with mid % 8 "
                             f"== 0, H*W % 4 == 0 and both halves, got mid {mid}, H*W {HW}")
        _check_aligned(t1=t1, w_hi=wp[0], w_lo=wp[1], **outs)
    return split


def conv1x1_mid(t1, count, wp, b2, beta2, mode, out, H, W):
    """out[s] = swish(W2 @ t1[s] + b2, beta2) for live slots s; the dead
    slots of out are not written. wp from :func:`prep_conv1x1_mid`: in the
    split modes, which run on the tensor cores (``tc_launches`` counts
    those launches), bfloat16 halves, K = mid <= TC_KMAX with mid % 8 == 0,
    H*W % 4 == 0 and 16-byte aligned tensors."""
    if not t1.is_cuda:
        return _conv1x1_mid_plain(t1, count, wp, b2, beta2, mode, out, H, W)
    B, mid, _ = t1.shape
    split = check_mid_product("conv1x1_mid", t1, wp, mode, count=count, b2=b2, out=out)
    _launch("imnf_conv1x1_mid", MODES[mode], _ptr(wp[0]), _ptr(wp[1]),
            _ptr(b2), float(beta2), _ptr(t1), _ptr(count), B, mid, H, W,
            _ptr(out))
    conv1x1_mid.launches += 1
    if split:
        conv1x1_mid.tc_launches += 1


def _conv3x3_out_by(product, t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W):
    """``conv3x3_out``'s function with ``product(v, wp, mode)`` for its 3x3
    product, wp W3's (hi, lo) in OIHW (untiled, float32, where the wrapper
    takes the tile layout); ``+ b3`` and the residual as the kernels take
    them."""
    n = int(count.item())
    e = idx[:n].long()
    mid, c = t2.shape[1], out.shape[1] // (H * W)
    wp = tuple(None if w is None else untile_w1t(w[None], c, mid)[0] if w.dim() == 3 else w
               for w in wp)
    y = product(t2[:n].reshape(n, mid, H, W), wp, mode) + b3[None, :, None, None]
    o = base.index_select(0, e) + sgn * y.flatten(1)
    if sub is not None:
        o = o - sub.index_select(0, e)
    out[e] = o


def _conv3x3_out_plain(t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W):
    _conv3x3_out_by(lambda v, w, m: _mconv(v, w, m, 1), t2, idx, count, wp, b3, mode, base,
                    sgn, sub, out, H, W)


def conv3x3_out(t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W):
    """out[idx[s]] = base[idx[s]] + sgn * (conv3x3(t2[s]) + b3)
    [- sub[idx[s]]] for live slots s; base/sub/out are (B, D) with
    D = c*H*W (the residual g = x_embed - g_z(z) - z, or x_embed = x +
    g_x(x)); the rows of the other examples are not written. wp W3's
    (hi, lo) from :func:`prep_conv3x3_out`: in the split modes, which run
    on the tensor cores (``csrc/conv3x3_out_tc.cuh``; ``tc_launches``
    counts those launches), bfloat16 halves in the tile layout, with what
    :func:`check_conv3x3_tc` asks of the shapes and 16-byte aligned t2 and
    halves; float32 OIHW in modes f32 / bf16 (the CUDA cores)."""
    if not t2.is_cuda:
        return _conv3x3_out_plain(t2, idx, count, wp, b3, mode, base, sgn,
                                  sub, out, H, W)
    B, mid, HW = t2.shape
    c = out.shape[1] // HW
    split = mode in SPLIT_MODES
    _check_cuda(t2=t2, idx=idx, count=count, b3=b3, base=base, sub=sub, out=out)
    _check_cuda(_dtypes=(torch.bfloat16 if split else torch.float32,), w_hi=wp[0],
                w_lo=wp[1])
    if split:
        check_conv3x3_tc("conv3x3_out", c, mid, H, W, C3_OUT_ROWS, split_out=True, t2=t2,
                         w_hi=wp[0], w_lo=wp[1])
    wshape = (mid // C3_MID, 9 * c3_out_npad(c), C3_MID) if split else (c, mid, 3, 3)
    if (tuple(wp[0].shape) != wshape or HW != H * W or out.shape[1] != c * HW
            or tuple(base.shape) != tuple(out.shape)):
        raise ValueError(f"conv3x3_out: t2 {tuple(t2.shape)}, w {tuple(wp[0].shape)}, base "
                         f"{tuple(base.shape)}, out {tuple(out.shape)} at H {H}, W {W}")
    if split and (wp[1] is None or tuple(wp[1].shape) != wshape):
        raise ValueError(f"conv3x3_out in {mode} takes both halves of the split")
    _launch("imnf_conv3x3_out", MODES[mode], _ptr(wp[0]), _ptr(wp[1]),
            _ptr(b3), _ptr(t2), _ptr(idx), _ptr(count), B, c, mid, H, W,
            _ptr(base), float(sgn), _ptr(sub), _ptr(out),
            C3_SOLVE_GROUPS[c3_out_npad(c)] if split else 1)
    conv3x3_out.launches += 1
    if split:
        conv3x3_out.tc_launches += 1


class StepPlan(NamedTuple):
    """How ``broyden_step``'s kernel (``csrc/broyden_step.cu``) cuts one
    example's D elements: a thread-block cluster of ``cluster`` CTAs a live
    example, CTA r owning elements [r * slice, (r + 1) * slice) as
    slice / 4 float4 vectors, thread t of ``threads`` the vectors t + m *
    threads, m < ``vpt``."""
    cluster: int
    slice: int
    threads: int
    vpt: int


STEP_CLUSTERS = (8, 4)  # the cluster sizes broyden_step takes, the larger first
STEP_MAX_THREADS = 256
STEP_VPT = (1, 2, 4)  # the kernel's instantiations (float4 vectors a thread)


def broyden_plan(D, K):
    """:class:`StepPlan` of ``broyden_step`` at D elements an example and K
    secant planes: the largest cluster of STEP_CLUSTERS that splits D into
    whole float4 vectors, the fewest vectors a thread (STEP_VPT) that keep
    a CTA at most STEP_MAX_THREADS threads (a multiple of 32). Raises on a
    D it cannot split and on K over KMAX."""
    if K > KMAX:
        raise ValueError(f"threshold {K} > {KMAX} is not taken by broyden_step")
    cluster = next((c for c in STEP_CLUSTERS if D > 0 and D % (4 * c) == 0), None)
    if cluster is None:
        raise ValueError(f"broyden_step splits D over {STEP_CLUSTERS} CTAs in float4 "
                         f"vectors: D % {4 * STEP_CLUSTERS[-1]} == 0, not D {D}")
    nv = D // cluster // 4
    vpt = next((v for v in STEP_VPT if -(-nv // v) <= STEP_MAX_THREADS), None)
    if vpt is None:
        raise ValueError(f"broyden_step takes D <= "
                         f"{4 * STEP_CLUSTERS[0] * STEP_MAX_THREADS * STEP_VPT[-1]}, not D {D}")
    return StepPlan(cluster, D // cluster, (-(-nv // vpt) + 31) // 32 * 32, vpt)


class _PlainSums:
    """The plain version's sums (torch's own order): the norm, the
    contractions over D, the combinations over k and the dot products."""

    @staticmethod
    def norm(v):
        return torch.linalg.vector_norm(v, dim=1)

    @staticmethod
    def contract(planes, vec, live):  # (n, k) coefficients <plane_k, vec>, k < nk
        return torch.where(live, torch.einsum("nkd,nd->nk", planes, vec), 0.0)

    @staticmethod
    def combine(coef, planes, live):  # sum_k coef_k plane_k
        return torch.einsum("nk,nkd->nd", coef, planes)

    @staticmethod
    def dot(a, b):
        return torch.sum(a * b, 1, keepdim=True)


def _broyden_step_by(sums, phase, idx_in, cnt_in, idx_out, cnt_out, st, *, eps,
                     cap, patience, rtol, guard_eps, newton, line_search=False):
    """``broyden_step``'s function with ``sums`` (:class:`_PlainSums`'
    methods) for its sums; every other operation as the plain version
    rounds it."""
    n = int(cnt_in.item())
    e = idx_in[:n].long()
    Z, G, UPD, ZN, GN, BZ, BG, U, V, ist, fst = (
        st[k] for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG", "U", "V",
                        "ist", "fst"))
    gn = GN[e]
    nk = ist[e, 0]
    obj = sums.norm(gn)
    kmax = int(nk.max().item()) if n else 0
    live = torch.arange(kmax, device=gn.device)[None, :] < nk[:, None]
    contract = lambda planes, vec: sums.contract(planes, vec, live)
    combine = lambda coef, planes: sums.combine(coef, planes, live)

    if phase == PHASE_INIT:
        z = ZN[e]
        upd = gn if newton else -gn
        done = obj < eps
        for buf, val in ((Z, z), (G, gn), (BZ, z), (BG, gn), (UPD, upd),
                         (ZN, z + upd)):
            buf[e] = val
        nstep = torch.zeros_like(nk)
        zero = torch.zeros_like(nk)
        ist[e] = torch.stack([zero, zero, zero, done.int()], 1)
        fst[e] = torch.stack([obj, obj, obj], 1)
    elif phase == PHASE_REARM:
        bz = BZ[e]
        Ue, Ve = U[e, :kmax], V[e, :kmax]
        upd = gn - combine(contract(Ve, gn), Ue)
        for buf, val in ((Z, bz), (G, gn), (BG, gn), (UPD, upd), (ZN, bz + upd)):
            buf[e] = val
        done = (ist[e, 2] > 0) | (obj < eps)
        ist[e, 3] = done.int()
        fst[e, 0] = obj
        fst[e, 1] = obj
        nstep = nk
    else:
        zn, dg = ZN[e], gn - G[e]
        dz = zn - Z[e] if line_search else UPD[e]  # the step taken
        nstep = nk + 1
        best_obj, best_snap, init_obj = fst[e].unbind(1)
        improved = obj < best_obj
        best_obj = torch.where(improved, obj, best_obj)
        best_step = torch.where(improved, nstep, ist[e, 1])
        bad = ~torch.isfinite(obj) | (obj > init_obj * PROTECT_THRES)
        prot = (ist[e, 2] > 0) | bad
        done = bad | (obj < eps)
        if patience > 0:
            at_check = (nstep % patience) == 0
            stalled = at_check & (best_obj > best_snap * (1.0 - rtol))
            if guard_eps > 0:
                stalled = stalled & (best_obj < guard_eps)
            done = done | stalled
            best_snap = torch.where(at_check, best_obj, best_snap)
        Ue, Ve = U[e, :kmax], V[e, :kmax]
        uvd = combine(contract(Ve, dg), Ue)
        uvg = combine(contract(Ve, gn), Ue)
        vt = -dz + combine(contract(Ue, dz), Ve)
        denom = sums.dot(vt, dg)
        u = (dz - (-dg + uvd)) / denom
        vt = torch.where(torch.isfinite(vt), vt, 0.0)
        u = torch.where(torch.isfinite(u), u, 0.0)
        cols = nk.long()
        U[e, cols] = u
        V[e, cols] = vt
        upd = -(-gn + uvg) - u * sums.dot(vt, gn)
        imp = improved[:, None]
        BZ[e] = torch.where(imp, zn, BZ[e])
        BG[e] = torch.where(imp, gn, BG[e])
        for buf, val in ((Z, zn), (G, gn), (UPD, upd), (ZN, zn + upd)):
            buf[e] = val
        ist[e] = torch.stack([nstep, best_step, prot.int(), done.int()], 1)
        fst[e] = torch.stack([best_obj, best_snap, init_obj], 1)
    keep = e[~done & (nstep < cap)]
    idx_out[:len(keep)] = keep.int()
    cnt_out.fill_(len(keep))


def _broyden_step_plain(phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw):
    _broyden_step_by(_PlainSums, phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw)


def broyden_step(phase, idx_in, cnt_in, idx_out, cnt_out, st, *, eps, cap,
                 patience, rtol, guard_eps, newton, line_search=False):
    """One Broyden iteration (``phase`` PHASE_STEP), the initialisation
    (PHASE_INIT) or a ladder re-arm (PHASE_REARM) for every live example
    of ``idx_in``; the still-active examples are written to ``idx_out`` /
    ``cnt_out``. ``st`` holds the solver state (see :func:`_solve`). With
    ``line_search`` the secant update takes the step actually taken,
    ``ZN - Z`` (``ops.line_search`` may have shortened it), else ``UPD``.
    On the card each live example runs on a thread-block cluster
    (:func:`broyden_plan`)."""
    if not st["Z"].is_cuda:
        return _broyden_step_plain(phase, idx_in, cnt_in, idx_out, cnt_out, st,
                                   eps=eps, cap=cap, patience=patience,
                                   rtol=rtol, guard_eps=guard_eps,
                                   newton=newton, line_search=line_search)
    B, K, D = st["U"].shape
    plan = broyden_plan(D, K)
    _check_cuda(idx_in=idx_in, cnt_in=cnt_in, idx_out=idx_out, cnt_out=cnt_out,
                **st)
    _check_aligned(**{k: st[k] for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG", "U", "V")})
    cnt_out.zero_()
    _launch("imnf_broyden_step", phase, _ptr(idx_in), _ptr(cnt_in),
            _ptr(idx_out), _ptr(cnt_out),
            *(_ptr(st[k]) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG",
                                    "U", "V", "ist", "fst")),
            B, D, K, eps, cap, patience, rtol, guard_eps, int(newton),
            int(line_search), *plan)
    broyden_step.launches += 1


KERNELS = {"conv3x3_in": conv3x3_in, "conv1x1_mid": conv1x1_mid,
           "conv3x3_out": conv3x3_out, "broyden_step": broyden_step}
_PLAIN = {"conv3x3_in": _conv3x3_in_plain, "conv1x1_mid": _conv1x1_mid_plain,
          "conv3x3_out": _conv3x3_out_plain, "broyden_step": _broyden_step_plain}
for _fn in KERNELS.values():
    _fn.launches = 0
conv1x1_mid.tc_launches = 0  # their launches on the tensor cores (split modes)
conv3x3_in.tc_launches = conv3x3_out.tc_launches = 0


def solve_ops(plain=False) -> dict:
    """The solve's kernels (or, with ``plain``, their plain versions) with
    the line search's (``ops/line_search.py``, which imports this module)."""
    from . import line_search as lsm

    return {**_PLAIN, **lsm._PLAIN} if plain else {**KERNELS, **lsm.KERNELS}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    conv1x1_mid.tc_launches = conv3x3_in.tc_launches = conv3x3_out.tc_launches = 0


# ---------------------------------------------------------------------------
# the solve

def _solve(x, data_x, data_z, ops, *, threshold, eps, stall_patience,
           stall_rtol, stall_guard, newton_init, warm_start, mode, tail_mode,
           tail_start, line_search, linearise=False):
    """The solve on the kernels (or plain versions) of ``ops``; returns
    ``(FusedSolveResult, lin)``. With ``linearise`` (the merged block
    forward, ``fused_solve.py:1746, 1780``) the phase-1 evaluation of net x
    at x and one more evaluation of net z at the best iterate, in the
    phase-1 mode, run ``ops``' ``lin_conv3x3_in`` / ``lin_conv1x1_mid``, and
    ``lin`` is ``{'x' | 'z': (s0 (B, c*H*W), s1, s2 (B, mid, H*W))}``, the
    float32 swish derivatives (s0 ones without preact); else lin is None.
    With ``line_search`` every iteration of every stage runs the Armijo
    search (``ops.line_search``) on ``ops["line_search"]``, its trial
    residuals through ``net`` in the stage's mode."""
    from .line_search import PHASE_HALF, PHASE_PICK, PHASE_TEST, line_search_buffers

    if mode not in MODES:
        raise ValueError(f"unknown precision mode {mode!r}; valid: {sorted(MODES)}")
    B, c, H, W = x.shape
    HW, D, K = H * W, c * H * W, int(threshold)
    dev = x.device
    # thresholds as the reference compares them: python floats cast to f32
    eps_i = float(eps) * D ** 0.5
    eps_f = float(torch.tensor(eps_i, dtype=torch.float32))
    guard_eps = (float(torch.tensor(stall_guard * eps_i, dtype=torch.float32))
                 if stall_guard is not None else 0.0)
    patience = int(stall_patience) if stall_patience is not None else 0
    modes, starts = norm_ladder(K, tail_mode, tail_start)
    for m in modes:
        if m not in MODES:
            raise ValueError(f"unknown precision stage {m!r}")
    caps = ([starts[0]] if modes else []) + [
        starts[j + 1] if j + 1 < len(starts) else K for j in range(len(modes))]
    if not modes:
        caps = [K]
    nets = {}
    for name, data in (("x", data_x), ("z", data_z)):
        nets[name] = dict(
            b1=data["b1"].detach().float().contiguous(),
            b2=data["b2"].detach().float().contiguous(),
            b3=data["b3"].detach().float().contiguous(),
            betas=[float(v) for v in data["betas"].detach().float().cpu()],
            preact=bool(data["preact"]), data=data, prepped={})
    mid = data_z["w2"].shape[0]

    zeros = lambda *s, dt=torch.float32: torch.zeros(*s, device=dev, dtype=dt)
    X = x.detach().float().reshape(B, D).contiguous()
    st = {k: zeros(B, D) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG")}
    st["U"], st["V"] = zeros(B, K, D), zeros(B, K, D)
    st["ist"], st["fst"] = zeros(B, 4, dt=torch.int32), zeros(B, 3)
    XE = zeros(B, D)
    T1, T2 = zeros(B, mid, HW), zeros(B, mid, HW)
    lists = [zeros(B, dt=torch.int32), zeros(B, dt=torch.int32)]
    counts = [zeros(1, dt=torch.int32), zeros(1, dt=torch.int32)]
    ls = line_search_buffers(B, D, dev) if line_search else None

    lin = None
    if linearise:
        lin = {name: ((torch.empty if nets[name]["preact"] else torch.ones)(
                          B, D, device=dev),
                      torch.empty(B, mid, HW, device=dev),
                      torch.empty(B, mid, HW, device=dev)) for name in nets}

    def net(name, m, inp, idx, cnt, base, sgn, sub, out, s=None):
        """net(inp) into the residual ``out``; with ``s`` (every example
        live) the linearisation variants also write s = (s0, s1, s2), and
        no ``out`` skips the last conv."""
        nd = nets[name]
        if m not in nd["prepped"]:
            nd["prepped"][m] = prep_weights(nd["data"], m)
        wp = nd["prepped"][m]
        if s is None:
            ops["conv3x3_in"](inp.view(B, c, H, W), idx, cnt, wp["w1_in"], nd["b1"],
                              nd["betas"], nd["preact"], m, T1)
            ops["conv1x1_mid"](T1, cnt, wp["w2_mid"], nd["b2"], nd["betas"][2], m, T2, H, W)
        else:
            ops["lin_conv3x3_in"](inp.view(B, c, H, W), wp["w1_in"], nd["b1"], nd["betas"],
                                  nd["preact"], m, T1, s[1], s[0])
            ops["lin_conv1x1_mid"](T1, wp["w2_mid"], nd["b2"], nd["betas"][2], m, T2, s[2],
                                   H, W)
        if out is not None:
            ops["conv3x3_out"](T2, idx, cnt, wp["w3_tc"], nd["b3"], m, base, sgn, sub,
                               out, H, W)

    def step(phase, cap):
        ops["broyden_step"](phase, lists[0], counts[0], lists[1], counts[1], st,
                            eps=eps_f, cap=cap, patience=patience,
                            rtol=float(stall_rtol), guard_eps=guard_eps,
                            newton=bool(newton_init), line_search=bool(line_search))
        lists.reverse()
        counts.reverse()
        return int(counts[0].item())  # the one host read per iteration

    def search(m):
        """The Armijo search after GN = g(ZN): the test, the quadratic
        trial's residual on the fail list, its pick, the halved trial's on
        the half list and its pick (``ops.line_search``; no host read)."""
        ops["line_search"](PHASE_TEST, st, ls, lists[0], counts[0])
        net("z", m, ls["ZQ"], ls["fail"], ls["nfail"], XE, -1.0, ls["ZQ"], ls["GQ"])
        ops["line_search"](PHASE_HALF, st, ls)
        net("z", m, ls["ZH"], ls["half"], ls["nhalf"], XE, -1.0, ls["ZH"], ls["GH"])
        ops["line_search"](PHASE_PICK, st, ls)

    def run(m, cap, n):
        while n > 0:
            net("z", m, st["ZN"], lists[0], counts[0], XE, -1.0, st["ZN"], st["GN"])
            if line_search:
                search(m)
            n = step(PHASE_STEP, cap)

    stage_modes = (mode,) + tuple(modes)
    lists[0].copy_(torch.arange(B, dtype=torch.int32, device=dev))
    counts[0].fill_(B)
    net("x", mode, X, lists[0], counts[0], X, 1.0, None, XE,
        s=lin["x"] if linearise else None)
    if warm_start:
        st["ZN"].copy_(X)
    net("z", mode, st["ZN"], lists[0], counts[0], XE, -1.0, st["ZN"], st["GN"])
    run(mode, caps[0], step(PHASE_INIT, caps[0]))
    for m, cap in zip(stage_modes[1:], caps[1:]):
        need = (st["ist"][:, 2] == 0) & (st["fst"][:, 0] >= eps_f)
        e = need.nonzero().flatten().int()
        if len(e) == 0:
            break  # stages nest: nobody needs a later one either
        lists[0][:len(e)] = e
        counts[0].fill_(len(e))
        net("x", m, X, lists[0], counts[0], X, 1.0, None, XE)
        net("z", m, st["BZ"], lists[0], counts[0], XE, -1.0, st["BZ"], st["GN"])
        run(m, cap, step(PHASE_REARM, cap))
    if linearise:
        net("z", mode, st["BZ"], None, None, None, 0.0, None, None, s=lin["z"])

    ist, fst = st["ist"], st["fst"]
    diff = fst[:, 0].clone()
    return FusedSolveResult(
        result=st["BZ"].reshape(B, c, H, W), gx=st["BG"].reshape(B, c, H, W),
        nstep=ist[:, 0].clone(), diff=diff, prot_break=ist[:, 2] > 0,
        converged=diff < eps_f), lin


def fused_broyden_solve(x, data_x, data_z, *, threshold, eps, stall_patience,
                        stall_rtol, stall_guard=None, newton_init=False,
                        warm_start=False, mode="tf32", tail_mode=None,
                        tail_start=None, line_search=False) -> FusedSolveResult:
    """Solve ``z : x + g_x(x) = z + g_z(z)`` per example.

    x: (B, c, H, W); data_x / data_z: ``LipschitzNet.conv_forward_data``
    dicts of the embedding net (evaluated at x) and the solved net.
    mode: phase-1 precision 'f32' | 'tf32' | 'tf32x' | 'bf16';
    tail_mode / tail_start: the precision ladder (:func:`norm_ladder`).
    line_search: the Armijo search (``ops.line_search``) every iteration.
    CUDA tensors run the kernels, CPU tensors their plain versions."""
    return _solve(x, data_x, data_z, solve_ops(), threshold=threshold, eps=eps,
                  stall_patience=stall_patience, stall_rtol=stall_rtol,
                  stall_guard=stall_guard, newton_init=newton_init,
                  warm_start=warm_start, mode=mode, tail_mode=tail_mode,
                  tail_start=tail_start, line_search=line_search)[0]


def fused_broyden_solve_plain(x, data_x, data_z, **kwargs) -> FusedSolveResult:
    """:func:`fused_broyden_solve` with every kernel replaced by its plain
    PyTorch version, on whatever device ``x`` lies."""
    kwargs.setdefault("stall_guard", None)
    kwargs.setdefault("newton_init", False)
    kwargs.setdefault("warm_start", False)
    kwargs.setdefault("mode", "tf32")
    kwargs.setdefault("tail_mode", None)
    kwargs.setdefault("tail_start", None)
    kwargs.setdefault("line_search", False)
    return _solve(x, data_x, data_z, solve_ops(plain=True), **kwargs)[0]
