"""The implicit gradient of a block with its CUDA kernels: the backward
Broyden solve and the re-attachment VJP.

Port of ``ops/fused_solve.py::fused_backward_solve`` (TPU kernel at
``fused_solve.py:930``; ``_backward_kernel`` :893, ``_make_apply_jt`` :867)
and ``::fused_reattach_vjp`` (TPU kernel at ``fused_solve.py:1226``;
``_reattach_vjp_kernel`` :1146, ``_net_vjp_in_kernel`` :1093) of the JAX
package. The TPU kernels hold one example's operands in VMEM per grid step;
on Hopper both are host-driven sequences of batched kernels from
``csrc/implicit_grad.cu`` (that file's header says what bounds each on an
H100 and what its design does about it), with the conv kernels shared with
the forward solve through ``csrc/conv_gemm.cuh``. In mode bf16 every product
runs on the tensor cores: ``jt_conv3x3_in`` (``csrc/conv3x3_in_tc.cuh``, with
W3^T cast to bfloat16 once per solve by :func:`prep_mid_weight`),
``jt_conv1x1_mid`` (``csrc/mma_gemm.cuh``, with W2^T cast the same way),
``rv_conv1x1_mid`` (the same kernel, W2 and W2^T cast to bfloat16 once per
VJP by :func:`prep_rv_mid_weight`), ``rv_conv3x3_in`` (the c -> mid
kernel's ``EPI_AFFINE``, W1 and W3^T cast the same way), ``rv_wgrad``
(``csrc/wgrad_tc.cuh``), ``rv_conv3x3_out`` and ``jt_conv3x3_out``
(``csrc/conv3x3_out_tc.cuh``):

* backward solve ``u (I + J_gz) = grad``: per iteration ``jt_conv3x3_in`` ->
  ``jt_conv1x1_mid`` -> ``jt_conv3x3_out`` evaluate the residual
  ``u + J^T u - grad`` for the live examples, and the forward solve's
  ``broyden_step`` does the secant algebra. Zero init, Newton first step,
  best iterate returned, the forward solve's protective break and stall
  exit, no precision ladder (``fused_solve.py:893-1000``); under
  ``line_search`` the Armijo search of ``ops.line_search`` after each
  residual, its trial residuals through the same three kernels on the
  search's lists.
* re-attachment VJP of ``(x, data_x, data_z) -> x + g_x(x) - g_z(z_hat)``
  with cotangent ``u``: per net ``rv_conv3x3_in`` / ``rv_conv1x1_mid``
  recompute the pre-activations and run the cotangent products,
  ``rv_conv3x3_out`` the last one, ``rv_wgrad`` + ``rv_wgrad_reduce`` the
  weight gradients and ``rv_chan_sums`` the bias and swish-slope gradients
  and ``d_x = u + J_gx^T u``. Net z sees cotangent ``-u``; it needs no
  ``d_h`` but runs its last cotangent product when preact, for dbeta0.

The weight gradients come out in OIHW: the JAX im2col layouts and their
adjoints (``fused_solve.py:1212-1223``) are layout, not semantics.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors; a CUDA tensor never falls back. Each wrapper counts
its launches in ``<wrapper>.launches``. :func:`fused_backward_solve_plain`
and :func:`fused_reattach_vjp_plain` force the plain versions on any device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import line_search as lsm
from .fused_solve import (C3_OUT_ROWS, MODES, PHASE_INIT, PHASE_STEP, TC_KMAX,
                          _broyden_step_plain, _check_aligned, _check_cuda, _launch, _mconv,
                          _ptr, _split, _wide, _widened, broyden_step, check_conv3x3_tc,
                          conv3x3_in_rows, dswish, dswish_dbeta, prep_weight, swish)

__all__ = ["fused_backward_solve", "fused_backward_solve_plain",
           "fused_reattach_vjp", "fused_reattach_vjp_plain",
           "BackwardSolveResult", "transpose_weights", "KERNELS",
           "launch_counts", "reset_launch_counts", "BWD_MODES",
           "REATTACH_MODES", "DATA_KEYS", "mid_weight_dtype", "prep_mid_weight",
           "prep_rv_mid_weight", "chan_sums_plan", "ChanSumsPlan"]

BWD_MODES = ("f32", "bf16")
REATTACH_MODES = ("f32", "bf16", "tf32")
DATA_KEYS = ("w1", "w2", "w3", "b1", "b2", "b3", "betas")
ACTS = {"id": 0, "swish": 1, "dswish": 2}
WG_BK = 16          # rv_wgrad's reduction step on the CUDA cores
WG_TILE = 128       # the tensor-core rv_wgrad's output tile (csrc/wgrad_tc.cuh)
WG_KSTEP = 64       # its reduction step: H*W holds multiples of it
WG_TARGET_BLOCKS = 264  # 2 blocks per SM of the H100's 132


class BackwardSolveResult(NamedTuple):
    u: torch.Tensor           # (B, c, H, W) best iterate
    nstep: torch.Tensor       # (B,) int32
    diff: torch.Tensor        # (B,) best objective
    prot_break: torch.Tensor  # (B,) bool


def transpose_weights(w1, w2, w3):
    """The kernels of ``J^T = S0 C1^T S1 C2^T S2 C3^T``: a stride-1
    same-padding conv's adjoint is the conv with in/out swapped and the
    taps flipped, ``wt[i, o, ky, kx] = w[o, i, 2 - ky, 2 - kx]``. Returns
    (w3t (mid, c, 3, 3), w2t (mid, mid, 1, 1), w1t (c, mid, 3, 3))."""
    t = lambda w: w.flip(2, 3).transpose(0, 1).contiguous()
    return t(w3), w2.transpose(0, 1).contiguous(), t(w1)


# ---------------------------------------------------------------------------
# the library

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    "imnf_jt_conv3x3_in": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "imnf_jt_conv1x1_mid": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P],
    "imnf_jt_conv3x3_out": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                            _I, _P, _P, _P],
    "imnf_rv_conv3x3_in": [_I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P, _P],
    "imnf_rv_conv1x1_mid": [_I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P, _P],
    "imnf_rv_conv3x3_out": [_I, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I,
                            _P, _P],
    "imnf_rv_wgrad": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _L, _P, _P, _P, _P],
    "imnf_rv_wgrad_reduce": [_P, _I, _L, _F, _P, _P],
    "imnf_rv_chan_sums": [_P, _P, _F, _P, _I, _I, _I, _F, _P, _P, _P, _I, _I, _P],
}


def _lib():
    from . import cuda_build

    lib = cuda_build.load("implicit_grad")
    for fn, args in _ARGTYPES.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _run(fn, *args):
    _launch(fn, *args, lib=_lib())


def _mode(mode, allowed):
    if mode not in allowed:
        raise ValueError(f"precision mode {mode!r} not taken here; valid: {allowed}")
    return MODES[mode]


def _shapes(**named):
    """Raise unless each tensor (None skips) has the shape given with it:
    ``name=(tensor, shape)``."""
    for name, (t, shape) in named.items():
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def mid_weight_dtype(mode):
    """The dtype of a J^T stage's kernel on the card where a tensor-core
    kernel takes it in OIHW (``jt_conv3x3_in`` and ``jt_conv1x1_mid`` here,
    ``nc_jt_in`` and ``nc_jt_mid`` of ``ops.fused_chain``): bfloat16 in mode
    bf16 (the tensor cores' operand, prepared once per solve or step),
    float32 in mode f32."""
    return torch.bfloat16 if mode == "bf16" else torch.float32


def prep_mid_weight(w, mode):
    """``(w, None)``: a J^T kernel (W3^T, W2^T) in :func:`mid_weight_dtype`,
    cast once, exactly (its values are bfloat16 in mode bf16)."""
    return w.detach().to(mid_weight_dtype(mode)).contiguous(), None


def prep_rv_mid_weight(w, mode):
    """A re-attachment kernel as ``rv_conv1x1_mid`` (W2 or W2^T) and
    ``rv_conv3x3_in`` (W1 or W3^T) take it: in mode bf16 ``(w, None)`` cast
    once to bfloat16 (the tensor cores' operand; the cast is exact, as
    :func:`prep_weight` rounds it to the same values), else
    :func:`prep_weight`'s split for the CUDA cores."""
    return prep_mid_weight(w, mode) if mode == "bf16" else prep_weight(w, mode)


def _check_mid(w, mode, K, HW, **tensors):
    """Raise on what the 1x1 kernels of ``csrc/mma_gemm.cuh`` (the J^T
    stages, the final pair's fp_conv_mid) do not take: a kernel w not in
    :func:`mid_weight_dtype`, and in mode bf16 (the tensor cores) K over
    TC_KMAX or not a multiple of 8, H*W not a multiple of 4, or a tensor not
    16-byte aligned."""
    _check_cuda(_dtypes=(mid_weight_dtype(mode),), w=w)
    if mode != "bf16":
        return
    if K > TC_KMAX or K % 8 or HW % 4:
        raise ValueError(f"the tensor-core 1x1 product takes K <= {TC_KMAX} with K % 8 == 0 "
                         f"and H*W % 4 == 0, got K {K}, H*W {HW}")
    _check_aligned(w=w, **tensors)


def _scaled(y, s):
    """y * s with s in y's shape (the J^T stages' derivative factors; a
    bfloat16 s is widened, as the f32 stages of the TPU kernel take it)."""
    return y * s.reshape(y.shape).to(y.dtype)


def _check_scale(s, **others):
    """Check a J^T stage's operands; its derivative factor s may be float32
    or bfloat16. Returns the kernel's scale_bf16 flag."""
    _check_cuda(**others)
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"s: dtype {s.dtype} not taken")
    _check_cuda(_dtypes=(s.dtype, torch.float32, torch.int32), s=s, **others)
    return int(s.dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# backward solve: the three J^T stages. Active-list convention as in
# fused_solve: idx (B,) int32 example indices, count (1,) int32 live ones;
# intermediates t (B, mid, H*W) are indexed by slot; u, s0, s1, s2, base,
# sub and out by example. s0/s1/s2 are float32, or bfloat16 as mode bf16's
# linearisation makes them (read as stored).

def _jt_conv3x3_in_by(product, u, idx, count, wp, s2, mode, out):
    """``jt_conv3x3_in``'s function with ``product(x, wp, mode)`` for its 3x3
    product (wp widened to float32): the gather of the live examples before
    it and the scale by example after it, as the kernels take them."""
    n = int(count.item())
    e = idx[:n].long()
    mid = wp[0].shape[0]
    y = product(u.index_select(0, e), _widened(wp), mode)
    out[:n] = _scaled(y, s2.index_select(0, e)).flatten(2)


def _jt_conv3x3_in_plain(u, idx, count, wp, s2, mode, out):
    _jt_conv3x3_in_by(lambda x, w, m: _mconv(x, w, m, 1), u, idx, count, wp, s2, mode, out)


def jt_conv3x3_in(u, idx, count, wp, s2, mode, out):
    """out[s] = C3^T u[idx[s]] * s2[idx[s]] for live slots s: u (B, c, H, W);
    s2 and out (B, mid, H*W); the dead slots of out are not written. wp from
    :func:`prep_mid_weight` of w3t (mid, c, 3, 3): bfloat16 in mode bf16,
    which runs on the tensor cores (``csrc/conv3x3_in_tc.cuh``) and takes
    what :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with
    16-byte aligned s2 and out; float32 in mode f32."""
    if not u.is_cuda:
        return _jt_conv3x3_in_plain(u, idx, count, wp, s2, mode, out)
    B, c, H, W = u.shape
    mid = wp[0].shape[0]
    sbf16 = _check_scale(s2, u=u, idx=idx, count=count, out=out)
    _check_cuda(_dtypes=(mid_weight_dtype(mode),), w=wp[0])
    if mode == "bf16":
        check_conv3x3_tc("jt_conv3x3_in", c, mid, H, W, conv3x3_in_rows(W), s2=s2, out=out)
    _shapes(idx=(idx, (B,)), count=(count, (1,)), w=(wp[0], (mid, c, 3, 3)),
            s2=(s2, (B, mid, H * W)), out=(out, (B, mid, H * W)))
    _run("imnf_jt_conv3x3_in", _mode(mode, BWD_MODES), _ptr(wp[0]), _ptr(u), _ptr(idx),
         _ptr(count), _ptr(s2), sbf16, B, c, H, W, mid, _ptr(out))
    jt_conv3x3_in.launches += 1


def _jt_conv1x1_mid_plain(t, idx, count, wp, s1, mode, out, H, W):
    n = int(count.item())
    e = idx[:n].long()
    mid = t.shape[1]
    y = _mconv(t[:n].reshape(n, mid, H, W), (wp[0].to(t.dtype), None), mode, 0)
    out[:n] = _scaled(y, s1.index_select(0, e)).reshape(n, mid, H * W)


def jt_conv1x1_mid(t, idx, count, wp, s1, mode, out, H, W):
    """out[s] = W2^T t[s] * s1[idx[s]] for live slots s; wp from
    :func:`prep_mid_weight` (W2^T in bfloat16 in mode bf16, which runs on
    the tensor cores); the dead slots of out are not written."""
    if not t.is_cuda:
        return _jt_conv1x1_mid_plain(t, idx, count, wp, s1, mode, out, H, W)
    B, mid, _ = t.shape
    sbf16 = _check_scale(s1, t=t, idx=idx, count=count, out=out)
    _check_mid(wp[0], mode, mid, H * W, t=t, s1=s1, out=out)
    _shapes(t=(t, (B, mid, H * W)), idx=(idx, (B,)), count=(count, (1,)),
            w=(wp[0], (mid, mid, 1, 1)), s1=(s1, t.shape), out=(out, t.shape))
    _run("imnf_jt_conv1x1_mid", _mode(mode, BWD_MODES), _ptr(wp[0]), None,
         _ptr(t), _ptr(idx), _ptr(count), _ptr(s1), sbf16, B, mid, H, W, _ptr(out))
    jt_conv1x1_mid.launches += 1


def _jt_conv3x3_out_plain(t, idx, count, wp, s0, mode, base, sub, out, H, W):
    n = int(count.item())
    e = idx[:n].long()
    mid = t.shape[1]
    y = _mconv(t[:n].reshape(n, mid, H, W), wp, mode, 1).flatten(1)
    out[e] = base.index_select(0, e) + y * s0.index_select(0, e) - sub.index_select(0, e)


def jt_conv3x3_out(t, idx, count, wp, s0, mode, base, sub, out, H, W):
    """out[e] = base[e] + s0[e] * C1^T t[s] - sub[e], e = idx[s], for live
    slots s: the residual ``u + J^T u - grad``; the dead examples of out are
    not written. wp the split of w1t (c, mid, 3, 3); s0, base, sub, out (B,
    c*H*W). Mode bf16 runs on the tensor cores
    (``csrc/conv3x3_out_tc.cuh``): it takes c <= 48, mid a multiple of 64,
    W 8, 16 or 32, H a multiple of 8 and a 16-byte aligned t."""
    if not t.is_cuda:
        return _jt_conv3x3_out_plain(t, idx, count, wp, s0, mode, base, sub, out, H, W)
    B, mid, _ = t.shape
    c = wp[0].shape[0]
    sbf16 = _check_scale(s0, t=t, idx=idx, count=count, w_hi=wp[0], w_lo=wp[1],
                         base=base, sub=sub, out=out)
    if mode == "bf16":
        check_conv3x3_tc("jt_conv3x3_out", c, mid, H, W, C3_OUT_ROWS, t=t)
    D = (B, c * H * W)
    _shapes(t=(t, (B, mid, H * W)), idx=(idx, (B,)), count=(count, (1,)),
            w=(wp[0], (c, mid, 3, 3)), s0=(s0, D), base=(base, D), sub=(sub, D),
            out=(out, D))
    _run("imnf_jt_conv3x3_out", _mode(mode, BWD_MODES), _ptr(wp[0]), _ptr(wp[1]),
         _ptr(t), _ptr(idx), _ptr(count), B, c, mid, H, W, _ptr(base), _ptr(s0),
         sbf16, _ptr(sub), _ptr(out))
    jt_conv3x3_out.launches += 1


# ---------------------------------------------------------------------------
# re-attachment VJP kernels. Every example is live: idx = arange(B),
# count = [B], so slot and example coincide.

def _act(v, h, beta, act):
    if act == "swish":
        return swish(v, beta)
    if act == "dswish":
        return v * dswish(h, beta)
    return v


def _affine(y, alpha, bias):
    y = alpha * y
    return y if bias is None else y + bias[None, :, None, None]


def _rv_conv3x3_in_by(product, inp, idx, count, wp, bias, alpha, beta_in, act, mode, out):
    """``rv_conv3x3_in``'s function with ``product(h, wp, mode)`` for its 3x3
    product: the gather and transform of the live examples before it,
    alpha and the bias after it, as the kernels take them."""
    n = int(count.item())
    h = _act(inp.index_select(0, idx[:n].long()), None, beta_in, act)
    y = _affine(product(h, wp, mode), alpha, bias)
    out[:n] = y.reshape(n, y.shape[1], -1)


def _rv_conv3x3_in_plain(inp, idx, count, wp, bias, alpha, beta_in, act, mode, out):
    _rv_conv3x3_in_by(lambda h, w, m: _mconv(h, _widened(w), m, 1), inp, idx, count, wp, bias,
                      alpha, beta_in, act, mode, out)


def rv_conv3x3_in(inp, idx, count, wp, bias, alpha, beta_in, act, mode, out):
    """out[s] = alpha * W1 act(inp[idx[s]]) [+ bias] for live slots s, act
    'id' | 'swish' (slope beta_in: a one-element tensor on the device, read
    there; None for 'id'), a 3x3 conv c -> mid: the pre-activation h1, and
    with the flipped w3 the raw cotangent t2 = sign * C3^T u; the dead
    slots of out are not written. wp from :func:`prep_rv_mid_weight`: in
    mode bf16 bfloat16, which runs on the tensor cores
    (``csrc/conv3x3_in_tc.cuh``'s ``EPI_AFFINE``: K tiles of 16, each a
    fresh float32 partial) and takes what
    :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with a
    16-byte aligned out."""
    if not inp.is_cuda:
        return _rv_conv3x3_in_plain(inp, idx, count, wp, bias, alpha, beta_in,
                                    act, mode, out)
    if act not in ("id", "swish"):
        raise ValueError(f"rv_conv3x3_in takes act 'id' | 'swish', not {act!r}")
    if act == "swish" and not (torch.is_tensor(beta_in) and beta_in.numel() == 1):
        raise ValueError("rv_conv3x3_in: beta_in must be a one-element tensor on the device")
    B, c, H, W = inp.shape
    mid = wp[0].shape[0]
    _check_cuda(inp=inp, idx=idx, count=count, bias=bias, out=out,
                beta_in=beta_in if act == "swish" else None)
    _check_cuda(_dtypes=(mid_weight_dtype(mode),), w_hi=wp[0])
    _check_cuda(w_lo=wp[1])
    if mode == "bf16":
        check_conv3x3_tc("rv_conv3x3_in", c, mid, H, W, conv3x3_in_rows(W), out=out)
    _shapes(idx=(idx, (B,)), count=(count, (1,)), w=(wp[0], (mid, c, 3, 3)),
            bias=(bias, (mid,)), out=(out, (B, mid, H * W)))
    _run("imnf_rv_conv3x3_in", _mode(mode, REATTACH_MODES), ACTS[act],
         _ptr(wp[0]), _ptr(wp[1]), _ptr(bias), float(alpha),
         _ptr(beta_in) if act == "swish" else None, _ptr(inp), _ptr(idx), _ptr(count),
         B, c, H, W, mid, _ptr(out))
    rv_conv3x3_in.launches += 1


def _rv_conv1x1_mid_plain(inp, inh, count, wp, bias, alpha, beta_in, act, mode,
                          out, H, W):
    n = int(count.item())
    mid = inp.shape[1]
    h = _act(inp[:n], inh[:n], beta_in, act).reshape(n, mid, H, W)
    out[:n] = _affine(_mconv(h, _widened(wp), mode, 0), alpha, bias).reshape(n, mid, H * W)


def rv_conv1x1_mid(inp, inh, count, wp, bias, alpha, beta_in, act, mode, out, H, W):
    """out[s] = alpha * W act(inp[s]) [+ bias] for slots s < count, act
    'swish' (h2 = W2 swish(h1) + b2) or 'dswish' (inp * swish'(inh): t1 =
    W2^T (t2 swish'(h2))); the slots past count are not written. inp, inh,
    out (B, mid, H*W); beta_in the slope, a one-element tensor on the
    device (read there: no host read); wp from :func:`prep_rv_mid_weight`.
    Mode bf16 runs on the tensor cores (``csrc/mma_gemm.cuh``): it takes
    alpha 1, mid <= TC_KMAX with mid % 8 == 0, H*W % 4 == 0 and 16-byte
    aligned tensors."""
    if not inp.is_cuda:
        return _rv_conv1x1_mid_plain(inp, inh, count, wp, bias, alpha, beta_in,
                                     act, mode, out, H, W)
    if act not in ("swish", "dswish"):
        raise ValueError(f"rv_conv1x1_mid takes act 'swish' | 'dswish', not {act!r}")
    if not torch.is_tensor(beta_in) or beta_in.numel() != 1:
        raise ValueError("rv_conv1x1_mid: beta_in must be a one-element tensor on the device")
    B, mid, _ = inp.shape
    _check_cuda(inp=inp, inh=inh, count=count, beta_in=beta_in, bias=bias, out=out)
    _check_mid(wp[0], mode, mid, H * W, inp=inp, inh=inh, out=out)
    _check_cuda(w_lo=wp[1])
    if mode == "bf16" and float(alpha) != 1.0:
        raise ValueError(f"rv_conv1x1_mid in bf16 takes alpha 1, not {alpha}")
    _shapes(inp=(inp, (B, mid, H * W)), inh=(inh, inp.shape), count=(count, (1,)),
            w=(wp[0], (mid, mid, 1, 1)), bias=(bias, (mid,)), out=(out, inp.shape))
    _run("imnf_rv_conv1x1_mid", _mode(mode, REATTACH_MODES), ACTS[act],
         _ptr(wp[0]), _ptr(wp[1]), _ptr(bias), float(alpha), _ptr(beta_in),
         _ptr(inp), _ptr(inh), _ptr(count), B, mid, H, W, _ptr(out))
    rv_conv1x1_mid.launches += 1


def _rv_conv3x3_out_plain(t, th, beta_in, idx, count, wp, mode, out, H, W):
    n = int(count.item())
    mid = t.shape[1]
    v = (t[:n] * dswish(th[:n], beta_in)).reshape(n, mid, H, W)
    out[idx[:n].long()] = _mconv(v, wp, mode, 1).reshape(n, -1)


def rv_conv3x3_out(t, th, beta_in, idx, count, wp, mode, out, H, W):
    """out[idx[s]] = C1^T (t[s] * swish'(th[s]; beta_in)) for live slots s:
    the last cotangent product t0. wp the split of w1t (c, mid, 3, 3); out
    (B, c*H*W). Mode bf16 runs on the tensor cores
    (``csrc/conv3x3_out_tc.cuh``): it takes c <= 48, mid a multiple of 64,
    W 8, 16 or 32, H a multiple of 8 and 16-byte aligned t and th."""
    if not t.is_cuda:
        return _rv_conv3x3_out_plain(t, th, beta_in, idx, count, wp, mode, out, H, W)
    B, mid, _ = t.shape
    c = wp[0].shape[0]
    _check_cuda(t=t, th=th, idx=idx, count=count, w_hi=wp[0], w_lo=wp[1], out=out)
    if mode == "bf16":
        check_conv3x3_tc("rv_conv3x3_out", c, mid, H, W, C3_OUT_ROWS, t=t, th=th)
    _shapes(t=(t, (B, mid, H * W)), th=(th, t.shape), idx=(idx, (B,)),
            count=(count, (1,)), w=(wp[0], (c, mid, 3, 3)), out=(out, (B, c * H * W)))
    _run("imnf_rv_conv3x3_out", _mode(mode, REATTACH_MODES), _ptr(wp[0]),
         _ptr(wp[1]), _ptr(t), _ptr(th), float(beta_in), _ptr(idx), _ptr(count),
         B, c, mid, H, W, _ptr(out))
    rv_conv3x3_out.launches += 1


def _cdiv(a, b):
    return -(-a // b)


def wgrad_splits(M, N, Bn, HW):
    """(splits, kchunk) of rv_wgrad over K = Bn examples x HW pixels: splits
    of whole examples (kchunk a multiple of HW), enough of them that the
    tensor-core grid of mode bf16 holds about WG_TARGET_BLOCKS blocks of
    WG_TILE x WG_TILE outputs. A shift never reaches across examples, so no
    product of a shifted operand crosses a split."""
    tiles = _cdiv(M * N, WG_TILE * WG_TILE)
    per = _cdiv(Bn, max(1, min(Bn, _cdiv(WG_TARGET_BLOCKS, tiles))))
    return _cdiv(Bn, per), per * HW


def _wgrad_operands(a, ah, beta_a, b, bh, beta_b, bin_, shift, H, W):
    """(A (M, K), B (N, K)) with K = batch x pixels, in float32, before the
    precision split."""
    Bn, M = a.shape[:2]
    A = a if ah is None else a * dswish(ah, beta_a)
    A = A.reshape(Bn, M, H * W).transpose(0, 1).reshape(M, -1)
    bt = b.reshape(Bn, -1, H, W)
    if bin_ == "swish":
        bt = swish(bt, beta_b)
    elif bin_ == "dswish":
        bt = bt * dswish(bh.reshape(bt.shape), beta_b)
    # (Bn, C*9, HW) with row ci*9 + ky*3 + kx, or (Bn, C, HW)
    Bm = F.unfold(bt, 3, padding=1) if shift else bt.reshape(Bn, bt.shape[1], -1)
    return A, Bm.transpose(0, 1).reshape(Bm.shape[1], -1)


def _rv_wgrad_plain(a, ah, beta_a, b, bh, beta_b, bin_, shift, mode, part, H, W):
    A, Bm = _wgrad_operands(a, ah, beta_a, b, bh, beta_b, bin_, shift, H, W)
    S, kchunk = wgrad_splits(A.shape[0], Bm.shape[0], a.shape[0], H * W)
    if S != part.shape[0]:
        raise ValueError(f"part holds {part.shape[0]} splits, rv_wgrad makes {S}")
    (Ah, Al), (Bh, Bl) = _split(A, mode), _split(Bm, mode)
    for s in range(S):
        k = slice(s * kchunk, (s + 1) * kchunk)
        acc = Ah[:, k] @ Bh[:, k].T
        if mode in ("tf32", "tf32x"):
            acc = acc + Ah[:, k] @ Bl[:, k].T + Al[:, k] @ Bh[:, k].T
        part[s] = acc


def rv_wgrad(a, ah, beta_a, b, bh, beta_b, bin_, shift, mode, part, H, W):
    """Split-K partial sums ``part[s] = sum_{k in split s} A[:, k] B[:, k]``
    over k = (example, pixel) of a weight gradient:

    * A = a (Bn, M, HW), or ``a * swish'(ah; beta_a)`` when ah is given;
    * B = bin_(b) of b (Bn, Cb, HW): 'id', 'swish' (slope beta_b) or
      'dswish' (``b * swish'(bh; beta_b)``), im2col-shifted when ``shift``
      (N = Cb*9, n = ci*9 + ky*3 + kx: a 3x3 kernel's gradient) or not
      (N = Cb).

    The re-attachment's dW3 = cot x shift(swish(h2)), dW2 = t2 swish'(h2) x
    swish(h1) and dW1 = t1 swish'(h1) x shift([swish](x)), and the final
    pair's products. Mode bf16 runs on the tensor cores: a pre-pass rounds
    A and B to bfloat16 scratch (allocated here) and a wgmma product sums
    them; it takes H*W a multiple of 64, W a multiple of 8 and 16-byte
    aligned inputs. The slopes are float32 device scalars (0-dim tensors),
    read by the kernel. ``part`` is (splits, M, N) with splits from
    :func:`wgrad_splits`."""
    if bin_ not in ACTS:
        raise ValueError(f"bin {bin_!r}: 'id' | 'swish' | 'dswish'")
    if not a.is_cuda:
        return _rv_wgrad_plain(a, ah, beta_a, b, bh, beta_b, bin_, shift, mode, part,
                               H, W)
    Bn, M = a.shape[:2]
    Cb = b.shape[1]
    S, _, N = part.shape
    splits, kchunk = wgrad_splits(M, N, Bn, H * W)
    if splits != S:
        raise ValueError(f"part holds {S} splits, rv_wgrad makes {splits}")
    if (H * W) % WG_BK:
        raise ValueError(f"rv_wgrad takes H*W a multiple of {WG_BK}, not {H * W}")
    if mode == "bf16" and ((H * W) % WG_KSTEP or W % 8):
        raise ValueError(f"rv_wgrad in bf16 takes H*W % {WG_KSTEP} == 0 and W % 8 == 0, "
                         f"not H {H}, W {W}")
    if ah is not None and beta_a is None:
        raise ValueError("ah needs beta_a")
    if bin_ != "id" and beta_b is None:
        raise ValueError(f"bin {bin_!r} needs beta_b")
    if bin_ == "dswish" and bh is None:
        raise ValueError("bin 'dswish' needs bh")
    _check_cuda(a=a, ah=ah, beta_a=beta_a, b=b, bh=bh, beta_b=beta_b, part=part)
    _shapes(a=(a.reshape(Bn, M, -1), (Bn, M, H * W)), ah=(ah, a.shape),
            b=(b.reshape(Bn, Cb, -1), (Bn, Cb, H * W)), bh=(bh, b.shape),
            beta_a=(beta_a, ()), beta_b=(beta_b, ()),
            part=(part, (S, M, Cb * 9 if shift else Cb)))
    a16 = b16 = None
    if mode == "bf16":  # the pre-pass's operands
        _check_aligned(a=a, ah=ah, b=b, bh=bh)
        a16 = torch.empty(Bn * M * H * W, device=a.device, dtype=torch.bfloat16)
        b16 = torch.empty(Bn * Cb * H * W, device=a.device, dtype=torch.bfloat16)
    _run("imnf_rv_wgrad", _mode(mode, REATTACH_MODES), ACTS["id" if ah is None else "dswish"],
         ACTS[bin_], int(bool(shift)), _ptr(a), _ptr(ah), _ptr(beta_a), _ptr(b), _ptr(bh),
         _ptr(beta_b), M, N, Cb, H, W, Bn, splits, kchunk, _ptr(a16), _ptr(b16), _ptr(part))
    rv_wgrad.launches += 1


def _rv_wgrad_reduce_plain(part, alpha, out):
    acc = part[0].clone()
    for s in range(1, part.shape[0]):
        acc += part[s]
    out.copy_((alpha * acc).reshape(out.shape))


def rv_wgrad_reduce(part, alpha, out):
    """out = alpha * sum_s part[s], the splits summed in order."""
    if not part.is_cuda:
        return _rv_wgrad_reduce_plain(part, alpha, out)
    _check_cuda(part=part, out=out)
    _shapes(out=(out.reshape(-1), (part[0].numel(),)))
    S = part.shape[0]
    _run("imnf_rv_wgrad_reduce", _ptr(part), S, part[0].numel(), float(alpha),
         _ptr(out))
    rv_wgrad_reduce.launches += 1


class ChanSumsPlan(NamedTuple):
    """How ``rv_chan_sums``' kernel (``csrc/chan_sums.cu``) cuts a channel's
    Bn x HW elements, taken example by example: a thread-block cluster of
    ``cluster`` CTAs a channel, CTA r owning elements [r * chunk, (r + 1) *
    chunk) as chunk / vec vectors of ``vec`` floats, thread t of
    CS_THREADS the vectors t + m * CS_THREADS."""
    cluster: int
    vec: int
    chunk: int


CS_THREADS = 256  # rv_chan_sums' CTA (csrc/chan_sums.cu)
CS_CLUSTERS = (1, 2, 4, 8, 16)  # its cluster sizes, the fewest first (16: non-portable)
CS_SMS = 132  # an H100's SMs: the grid the plan fills on the card


def chan_sums_plan(M, Bn, HW, vec=4, sms=CS_SMS):
    """:class:`ChanSumsPlan` of ``rv_chan_sums`` on t (Bn, M, HW): float4
    vectors (``vec`` 4) where HW % 4 == 0 and the caller's tensors are
    16-byte aligned (``vec`` 1 where not), and the fewest CTAs a channel of
    CS_CLUSTERS that give every SM one (the most where none does), halved
    until they split Bn * HW into whole vectors: 1 at M = mid 512, 16 at c 3
    and 12, 4 at c 48. More CTAs a channel than that lose on the card to
    their cluster barriers and half-idle threads (4 an SM: 1.3x at mid, 8x8;
    ``PERF.md`` §6). Takes every shape."""
    n = Bn * HW
    vec = 4 if vec == 4 and HW % 4 == 0 else 1
    cluster = next((c for c in CS_CLUSTERS if M * c >= sms), CS_CLUSTERS[-1])
    while n % (vec * cluster):
        cluster //= 2
    return ChanSumsPlan(cluster, vec, n // cluster)


def _rv_chan_sums_by(total, t, h, beta, alpha, base, sums, dbeta, out):
    """``rv_chan_sums``' function with ``total`` summing each row of its
    (M, Bn * HW) terms (a channel's, example by example); the terms as the
    plain version rounds them."""
    M = t.shape[1]
    chan = lambda v: total(v.transpose(0, 1).reshape(M, -1))
    g = t if h is None else t * dswish(h, beta)
    sums.copy_(alpha * chan(g))
    if dbeta is not None:
        dbeta.copy_(chan(t * dswish_dbeta(h, beta)))
    if out is not None:
        out.copy_(g if base is None else base + g)


def _rv_chan_sums_plain(t, h, beta, alpha, base, sums, dbeta, out):
    _rv_chan_sums_by(lambda p: p.sum(1), t, h, beta, alpha, base, sums, dbeta, out)


def rv_chan_sums(t, h, beta, alpha, base, sums, dbeta, out):
    """Per channel m of t (B, M, HW): sums[m] = alpha * sum g with g =
    t * swish'(h; beta) (or t when h is None); dbeta[m] = sum t *
    dswish/dbeta(h; beta) (when h is given); out = [base] + g (when out is
    given). On the card each channel runs on a thread-block cluster
    (:func:`chan_sums_plan`)."""
    if not t.is_cuda:
        return _rv_chan_sums_plain(t, h, beta, alpha, base, sums, dbeta, out)
    Bn, M, HW = t.shape
    _check_cuda(t=t, h=h, base=base, sums=sums, dbeta=dbeta, out=out)
    _shapes(h=(h, t.shape), base=(base, t.shape), out=(out, t.shape),
            sums=(sums, (M,)), dbeta=(dbeta, (M,)))
    plan = chan_sums_plan(M, Bn, HW, _chan_sums_vec(t, h, base, out), _sms(t.device))
    _run("imnf_rv_chan_sums", _ptr(t), _ptr(h), float(beta), _ptr(base), Bn, M,
         HW, float(alpha), _ptr(sums), _ptr(dbeta), _ptr(out), plan.cluster, plan.vec)
    rv_chan_sums.launches += 1


def _chan_sums_vec(*tensors):
    """4 where every tensor (None skips) is 16-byte aligned, else 1."""
    return 1 if any(t is not None and t.data_ptr() % 16 for t in tensors) else 4


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


KERNELS = {"jt_conv3x3_in": jt_conv3x3_in, "jt_conv1x1_mid": jt_conv1x1_mid,
           "jt_conv3x3_out": jt_conv3x3_out, "rv_conv3x3_in": rv_conv3x3_in,
           "rv_conv1x1_mid": rv_conv1x1_mid, "rv_conv3x3_out": rv_conv3x3_out,
           "rv_wgrad": rv_wgrad, "rv_wgrad_reduce": rv_wgrad_reduce,
           "rv_chan_sums": rv_chan_sums}
_PLAIN = {"jt_conv3x3_in": _jt_conv3x3_in_plain,
          "jt_conv1x1_mid": _jt_conv1x1_mid_plain,
          "jt_conv3x3_out": _jt_conv3x3_out_plain,
          "rv_conv3x3_in": _rv_conv3x3_in_plain,
          "rv_conv1x1_mid": _rv_conv1x1_mid_plain,
          "rv_conv3x3_out": _rv_conv3x3_out_plain,
          "rv_wgrad": _rv_wgrad_plain, "rv_wgrad_reduce": _rv_wgrad_reduce_plain,
          "rv_chan_sums": _rv_chan_sums_plain,
          "broyden_step": _broyden_step_plain, **lsm._PLAIN}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# the backward solve

def _backward_solve(grad, chain_data, ops, *, threshold, eps, stall_patience,
                    stall_rtol, stall_guard=None, newton_init=False, mode="bf16",
                    line_search=False):
    _mode(mode, BWD_MODES)
    B, c, H, W = grad.shape
    HW, D, K = H * W, c * H * W, int(threshold)
    dev = grad.device
    s0, s1, s2, w1, w2, w3 = (a.detach() for a in chain_data)
    mid = w2.shape[0]
    # the derivative factors as mode bf16's linearisation stores them, in
    # bfloat16; any other dtype in float32
    sdt = lambda s: s if s.dtype == torch.bfloat16 else s.float()
    S0 = sdt(s0).reshape(B, D).contiguous()
    S1 = sdt(s1).reshape(B, mid, HW).contiguous()
    S2 = sdt(s2).reshape(B, mid, HW).contiguous()
    w3t, w2t, w1t = transpose_weights(w1.float(), w2.float(), w3.float())
    wp1 = prep_weight(w1t, mode)
    # bfloat16 in mode bf16, once per solve
    wp3, wp2 = prep_mid_weight(w3t, mode), prep_mid_weight(w2t, mode)
    eps_i = float(eps) * D ** 0.5
    eps_f = float(torch.tensor(eps_i, dtype=torch.float32))
    guard_eps = (float(torch.tensor(stall_guard * eps_i, dtype=torch.float32))
                 if stall_guard is not None else 0.0)
    patience = int(stall_patience) if stall_patience is not None else 0

    zeros = lambda *s, dt=torch.float32: torch.zeros(*s, device=dev, dtype=dt)
    G = grad.detach().float().reshape(B, D).contiguous()
    st = {k: zeros(B, D) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG")}
    st["U"], st["V"] = zeros(B, K, D), zeros(B, K, D)
    st["ist"], st["fst"] = zeros(B, 4, dt=torch.int32), zeros(B, 3)
    T1, T2 = zeros(B, mid, HW), zeros(B, mid, HW)
    lists = [torch.arange(B, dtype=torch.int32, device=dev), zeros(B, dt=torch.int32)]
    counts = [torch.full((1,), B, dtype=torch.int32, device=dev),
              zeros(1, dt=torch.int32)]
    ls = lsm.line_search_buffers(B, D, dev) if line_search else None

    def resid(z=st["ZN"], out=st["GN"], idx=None, cnt=None):
        """out[e] = z[e] + J^T z[e] - grad[e] for the examples of the list
        (default: the live ones)."""
        idx, cnt = (lists[0], counts[0]) if idx is None else (idx, cnt)
        ops["jt_conv3x3_in"](z.view(B, c, H, W), idx, cnt, wp3, S2, mode, T2)
        ops["jt_conv1x1_mid"](T2, idx, cnt, wp2, S1, mode, T1, H, W)
        ops["jt_conv3x3_out"](T1, idx, cnt, wp1, S0, mode, z, G, out, H, W)

    def search():  # the Armijo search after GN = g(ZN) (ops.line_search; no host read)
        ops["line_search"](lsm.PHASE_TEST, st, ls, lists[0], counts[0])
        resid(ls["ZQ"], ls["GQ"], ls["fail"], ls["nfail"])
        ops["line_search"](lsm.PHASE_HALF, st, ls)
        resid(ls["ZH"], ls["GH"], ls["half"], ls["nhalf"])
        ops["line_search"](lsm.PHASE_PICK, st, ls)

    def step(phase):
        ops["broyden_step"](phase, lists[0], counts[0], lists[1], counts[1], st,
                            eps=eps_f, cap=K, patience=patience,
                            rtol=float(stall_rtol), guard_eps=guard_eps,
                            newton=bool(newton_init), line_search=bool(line_search))
        lists.reverse()
        counts.reverse()
        return int(counts[0].item())  # the one host read per iteration

    resid()  # at the zero init
    n = step(PHASE_INIT)
    while n > 0:
        resid()
        if line_search:
            search()
        n = step(PHASE_STEP)
    return BackwardSolveResult(
        u=st["BZ"].reshape(B, c, H, W), nstep=st["ist"][:, 0].clone(),
        diff=st["fst"][:, 0].clone(), prot_break=st["ist"][:, 2] > 0)


_SOLVE_OPS = {**KERNELS, "broyden_step": broyden_step, **lsm.KERNELS}


def fused_backward_solve(grad, chain_data, **kwargs) -> BackwardSolveResult:
    """Solve ``u (I + J_gz) = grad`` per example (``Backward.backward`` of
    the reference). ``chain_data`` = (s0, s1, s2, w1, w2, w3) from
    ``LipschitzNet.conv_chain_data`` at the linearisation point (the
    re-attached z), in the caller's precision cast. Keywords: threshold,
    eps, stall_patience, stall_rtol, stall_guard (None), newton_init
    (False), mode 'bf16' | 'f32' (rounds the J^T products' operands; the
    solver state stays float32), line_search (False: the Armijo search of
    ``ops.line_search`` after each residual). CUDA
    tensors run the kernels, CPU tensors their plain versions."""
    return _backward_solve(grad, chain_data, _SOLVE_OPS, **kwargs)


def fused_backward_solve_plain(grad, chain_data, **kwargs) -> BackwardSolveResult:
    """:func:`fused_backward_solve` with every kernel replaced by its plain
    PyTorch version, on whatever device ``grad`` lies."""
    return _backward_solve(grad, chain_data, _PLAIN, **kwargs)


# ---------------------------------------------------------------------------
# the re-attachment VJP

def _net_vjp(ops, mode, data, h, u, csign, idx, cnt, dx_out):
    """Weight, bias and slope gradients of one net at input h with
    cotangent csign * u; with dx_out, also dx_out = u + J^T u."""
    B, c, H, W = h.shape
    HW, dev, dt = H * W, h.device, u.dtype
    w1, w2, w3 = (data[k].detach().to(dt) for k in ("w1", "w2", "w3"))
    b1, b2 = (data[k].detach().to(dt).contiguous() for k in ("b1", "b2"))
    beta0, beta1, beta2 = (float(v) for v in data["betas"].detach().cpu())
    preact = bool(data["preact"])
    mid = w2.shape[0]
    hin = h.detach().to(dt).contiguous()
    w3t, w2t, w1t = transpose_weights(w1, w2, w3)
    # bfloat16 in mode bf16, once per VJP
    wp1, wp2, wt3, wt2 = (prep_rv_mid_weight(w, mode) for w in (w1, w2, w3t, w2t))
    wt1 = prep_weight(w1t, mode)
    bd = data["betas"].detach().to(dt).contiguous()  # the slopes on the device
    new = lambda *s: torch.empty(*s, device=dev, dtype=dt)
    H1, H2, T2, T1 = (new(B, mid, HW) for _ in range(4))

    # forward: the pre-activations h1, h2
    ops["rv_conv3x3_in"](hin, idx, cnt, wp1, b1, 1.0, bd[0:1] if preact else None,
                         "swish" if preact else "id", mode, H1)
    ops["rv_conv1x1_mid"](H1, H1, cnt, wp2, b2, 1.0, bd[1:2], "swish", mode, H2, H, W)
    # cotangents: t2 = C3^T cot, t1 = C2^T (t2 swish'(h2)), t0 = C1^T (...)
    ops["rv_conv3x3_in"](u, idx, cnt, wt3, None, csign, None, "id", mode, T2)
    ops["rv_conv1x1_mid"](T2, H2, cnt, wt2, None, 1.0, bd[2:3], "dswish", mode, T1, H, W)
    T0 = None
    if dx_out is not None or preact:
        T0 = new(B, c * HW)
        ops["rv_conv3x3_out"](T1, H1, beta1, idx, cnt, wt1, mode, T0, H, W)

    grads = {}
    for name, a, ah, beta_a, b, bin_, beta_b, shift, M, N, alpha in (
            ("w3", u, None, None, H2, "swish", bd[2], True, c, mid * 9, csign),
            ("w2", T2, H2, bd[2], H1, "swish", bd[1], False, mid, mid, 1.0),
            ("w1", T1, H1, bd[1], hin, "swish" if preact else "id",
             bd[0] if preact else None, True, mid, c * 9, 1.0)):
        splits, _ = wgrad_splits(M, N, B, HW)
        part = new(splits, M, N)
        ops["rv_wgrad"](a.reshape(B, M, HW) if name == "w3" else a, ah, beta_a,
                        b, None, beta_b, bin_, shift, mode, part, H, W)
        out = new(*data[name].shape)
        ops["rv_wgrad_reduce"](part, alpha, out)
        grads[name] = out

    grads["b3"] = new(c)
    ops["rv_chan_sums"](u.reshape(B, c, HW), None, 0.0, csign, None, grads["b3"],
                        None, None)
    dbeta = []
    for bname, t, hh, beta in (("b2", T2, H2, beta2), ("b1", T1, H1, beta1)):
        grads[bname], db = new(mid), new(mid)
        ops["rv_chan_sums"](t, hh, beta, 1.0, None, grads[bname], db, None)
        dbeta.append(db.sum())
    dbeta0 = torch.zeros((), device=dev, dtype=dt)
    if T0 is not None:
        db = new(c) if preact else None
        out = None if dx_out is None else dx_out.view(B, c, HW)
        base = None if dx_out is None else u.reshape(B, c, HW)
        ops["rv_chan_sums"](T0.view(B, c, HW), hin.view(B, c, HW) if preact else None,
                            beta0, 1.0, base, new(c), db, out)
        if preact:
            dbeta0 = db.sum()
    grads["betas"] = torch.stack([dbeta0, dbeta[1], dbeta[0]])
    return grads


def _reattach_vjp(x, z_hat, u, data_x, data_z, ops, mode):
    _mode(mode, REATTACH_MODES)
    B, c, H, W = x.shape
    dev = x.device
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
    U = u.detach().to(_wide(u.dtype)).contiguous()
    d_x = torch.empty(B, c * H * W, device=dev, dtype=U.dtype)
    gx = _net_vjp(ops, mode, data_x, x, U, 1.0, idx, cnt, d_x)
    gz = _net_vjp(ops, mode, data_z, z_hat, U, -1.0, idx, cnt, None)
    return d_x.view(B, c, H, W), gx, gz


def fused_reattach_vjp(x, z_hat, u, data_x, data_z, *, mode="bf16"):
    """VJP of ``(x, data_x, data_z) -> x + g_x(x) - g_z(z_hat)`` with
    cotangent ``u``: returns ``(d_x, d_data_x, d_data_z)``, the d_data dicts
    holding the gradients w.r.t. the EFFECTIVE kernels w1/w2/w3 (OIHW), the
    biases b1/b2/b3 and the softplus-resolved slopes ``betas`` of
    ``conv_forward_data``; autograd pulls them back to the raw parameters.
    mode 'bf16' | 'f32' | 'tf32' rounds every product's operands. CUDA
    tensors run the kernels, CPU tensors their plain versions."""
    return _reattach_vjp(x, z_hat, u, data_x, data_z, KERNELS, mode)


def fused_reattach_vjp_plain(x, z_hat, u, data_x, data_z, *, mode="bf16"):
    """:func:`fused_reattach_vjp` with the plain versions forced."""
    return _reattach_vjp(x, z_hat, u, data_x, data_z, _PLAIN, mode)
