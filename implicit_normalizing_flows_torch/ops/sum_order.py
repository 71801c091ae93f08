"""Plain versions of twenty-two kernels with their products or sums summed
exactly, and nineteen with them summed in their kernels' order.

Each ``*_exact`` function here is a kernel's plain version with its rounded
(bf16, or split) product summed in float64 and rounded once to float32: the
order of the float32 sums is taken out. Put in place of the plain version
inside a whole function (the backward solve, the re-attachment VJP, the
final pair), it reads that function's sum-order floor: how far any other
order of that product's sums moves the function's outputs. A limit set below
a floor fails every kernel that does not sum in the plain version's order.

* :func:`jt_conv1x1_mid_exact`: ``ops.implicit_grad._jt_conv1x1_mid_plain``.
* :func:`rv_wgrad_exact`: ``ops.implicit_grad._rv_wgrad_plain``.
* :func:`rv_conv3x3_out_exact`: ``ops.implicit_grad._rv_conv3x3_out_plain``.
* :func:`fp_conv_mid_exact`: ``ops.fused_final._fp_conv_mid_plain``.
* :func:`conv1x1_mid_exact`: ``ops.fused_solve._conv1x1_mid_plain`` (modes
  tf32 / tf32x: every pass of the split summed together).
* :func:`rv_conv1x1_mid_exact`: ``ops.implicit_grad._rv_conv1x1_mid_plain``.
* :func:`jt_conv3x3_out_exact`: ``ops.implicit_grad._jt_conv3x3_out_plain``
  (``C1^T t`` over mid x 9 terms; the residual's ops rounded in float32 as
  there).
* :func:`lin_conv1x1_mid_exact`: ``ops.fused_block._lin_conv1x1_mid_plain``
  (as :func:`conv1x1_mid_exact`, with s2 = swish'(h2) written too).
* :func:`nc_jt_in_exact`: ``ops.fused_chain._nc_jt_in_plain`` (``C3^T u``
  over c x 9 terms; ``rnd(y * s2)`` as there).
* :func:`lin_conv3x3_in_exact`: ``ops.fused_block._lin_conv3x3_in_plain``
  (every pass of the split; ``+ b1``, swish and swish' as there).
* :func:`conv3x3_in_exact`: ``ops.fused_solve._conv3x3_in_plain`` (the
  forward solve's, on its active list; every pass of the split; ``+ b1``
  and swish as there).
* :func:`nc_jt_out_acc_exact`: ``ops.fused_chain._nc_jt_out_acc_plain``
  (``C1^T t`` over mid x 9 terms; ``rnd(y * s0)`` and ``acc += c_k u`` as
  there).
* :func:`fp_conv_out_exact`: ``ops.fused_final._fp_conv_out_plain``
  (``C1^T t`` over mid x 9 terms, stored as it is).
* :func:`jt_conv3x3_in_exact`: ``ops.implicit_grad._jt_conv3x3_in_plain``
  (``C3^T u`` over c x 9 terms, on the active list; ``y * s2`` by example,
  unrounded, as there).
* :func:`fp_conv_in_exact`: ``ops.fused_final._fp_conv_in_plain`` (each
  net's ``W1 act(a)`` or ``C3^T acc`` over c x 9 terms; the transform and
  ``+ b1`` as there).
* :func:`rv_conv3x3_in_exact`: ``ops.implicit_grad._rv_conv3x3_in_plain``
  (``W1 [swish](h)`` or ``C3^T u`` over c x 9 terms, on the active list;
  alpha and ``+ b1`` as there).
* :func:`broyden_step_exact`: ``ops.fused_solve._broyden_step_plain`` (the
  norm, every contraction over D and combination over k and both dot
  products in float64, rounded once; every other operation as there).
* :func:`fp_tdot_exact`: ``ops.fused_final._fp_tdot_plain`` (each
  example's products, rounded as there, summed in float64).
* :func:`rv_chan_sums_exact`: ``ops.implicit_grad._rv_chan_sums_plain``
  (each channel's terms, rounded as there, summed in float64).
* :func:`line_search_exact`: ``ops.line_search._line_search_plain`` (each
  sum of squares in float64, rounded once; every other operation as
  there).
* :func:`broyden_update_exact`: ``ops.broyden_update.broyden_update_plain``
  (every contraction over D and combination over k and both dot products
  in float64, rounded once; every other operation as there).

:func:`fp_conv_in_exact` also stands in for its kernel on the CPU: the
final pair's c -> mid kernel (``csrc/conv3x3_in_tc.cuh``,
``conv3x3_in_dmma_kernel``) sums the exact bf16 products in float64 on the
FP64 tensor cores and rounds once, as it does (up to the float64 sums'
order).

The ``*_tiled`` functions are plain versions with their products summed as
the tensor-core kernels sum them. They stand in for those kernels on the
CPU. The 1x1 kernel (``csrc/mma_gemm.cuh``) sums each K tile of ``TC_BK``
channels into a fresh float32 partial, the partials added in order:

* :func:`fp_conv_mid_tiled` and :func:`rv_conv1x1_mid_tiled` (mode bf16);
* :func:`conv1x1_mid_tiled` and :func:`lin_conv1x1_mid_tiled` (tf32 /
  tf32x): per K tile one partial of hi*hi and one of the small passes
  hi*lo + lo*hi (+ lo*lo), each added to its own float32 sum; the epilogue
  adds the two sums, then b2, then swish (and swish') (modes f32 / bf16, on
  the CUDA cores: the plain version).

The 3x3 kernel (``csrc/conv3x3_out_tc.cuh``) takes the mid channels in
chunks of ``C3_MC`` and, within a chunk, the 9 taps in order, each (chunk,
tap) K tile into a fresh float32 partial added to the sum (in the split
modes one partial and sum of hi*hi and one of the small passes, the two
sums added before the bias):

* :func:`jt_conv3x3_out_tiled`, :func:`nc_jt_out_acc_tiled` and
  :func:`fp_conv_out_tiled` (mode bf16), :func:`conv3x3_out_tiled` (tf32 /
  tf32x).

The 3x3 c -> mid kernel (``csrc/conv3x3_in_tc.cuh``) sums over the im2col's
k = ci * 9 + ky * 3 + kx in K tiles of ``C3I_BK``, each tile's products into
a fresh float32 partial added to the sum (in the split modes, as the 1x1
kernel, one partial and sum of hi*hi and one of the small passes, the two
sums added before the bias):

* :func:`nc_jt_in_tiled`, :func:`jt_conv3x3_in_tiled` and
  :func:`rv_conv3x3_in_tiled` (mode bf16), :func:`lin_conv3x3_in_tiled` and
  :func:`conv3x3_in_tiled` (tf32 / tf32x);
* :func:`fp_conv_in_tiled` (mode bf16): the order of that kernel's
  ``EPI_AFFINE``, which the final pair does not take (its float64 form
  does); phase 9 of ``chip_smoke.py`` reads the pair with it.

The five reductions split over a thread-block cluster
(``csrc/cluster_reduce.cuh``) sum as :func:`_cluster_tree` says:
:func:`broyden_step_tiled`, :func:`fp_tdot_tiled`,
:func:`rv_chan_sums_tiled`, :func:`line_search_tiled` and
:func:`broyden_update_tiled` (whose warp form is a cluster of one warp).

They run on whatever device their tensors lie on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .broyden_update import _broyden_update_by, update_plan
from .fused_final import TDOT_THREADS, _fp_tdot_by, tdot_plan
from .fused_solve import (SPLIT_MODES, _broyden_step_by, _conv1x1_mid_plain, _conv3x3_in_by,
                          _conv3x3_in_plain, _conv3x3_out_by, _conv3x3_out_plain, _split,
                          _widened, broyden_plan, dswish, swish)
from .implicit_grad import CS_THREADS, _chan_sums_vec, _rv_chan_sums_by, chan_sums_plan
from .line_search import _line_search_by

__all__ = ["jt_conv1x1_mid_exact", "rv_wgrad_exact", "rv_conv3x3_out_exact",
           "fp_conv_mid_exact", "fp_conv_mid_tiled", "conv1x1_mid_exact",
           "conv1x1_mid_tiled", "rv_conv1x1_mid_exact", "rv_conv1x1_mid_tiled",
           "jt_conv3x3_out_exact", "jt_conv3x3_out_tiled", "lin_conv1x1_mid_exact",
           "lin_conv1x1_mid_tiled", "nc_jt_in_exact", "nc_jt_in_tiled",
           "lin_conv3x3_in_exact", "lin_conv3x3_in_tiled", "conv3x3_in_exact",
           "conv3x3_in_tiled", "nc_jt_out_acc_exact", "nc_jt_out_acc_tiled",
           "fp_conv_out_exact", "fp_conv_out_tiled", "jt_conv3x3_in_exact",
           "jt_conv3x3_in_tiled", "fp_conv_in_exact", "fp_conv_in_tiled",
           "rv_conv3x3_in_exact", "rv_conv3x3_in_tiled", "conv3x3_out_exact",
           "conv3x3_out_tiled", "broyden_step_exact", "broyden_step_tiled", "fp_tdot_exact",
           "fp_tdot_tiled", "rv_chan_sums_exact", "rv_chan_sums_tiled", "line_search_exact",
           "line_search_tiled", "broyden_update_exact", "broyden_update_tiled", "TC_BK",
           "C3_MC", "C3I_BK"]

TC_BK = 64  # the K tile of the tensor-core 1x1 product (csrc/mma_gemm.cuh)
C3_MC = 64  # the mid channels of a chunk of the tensor-core 3x3 product (csrc/conv3x3_out_tc.cuh)
C3I_BK = 16  # the K tile of the tensor-core 3x3 c -> mid product (csrc/conv3x3_in_tc.cuh)


def _exact(x, w, mode, mm):
    """``mm`` of the mode's passes (hi*hi [+ hi*lo + lo*hi [+ lo*lo]]) on
    the split of x and w (or w's split, a (hi, lo) pair), summed in float64,
    rounded once to float32."""
    xh, xl = _split(x.float(), mode)
    wh, wl = _widened(w) if isinstance(w, tuple) else _split(w.float(), mode)
    d = lambda t: t.double()
    out = mm(d(xh), d(wh))
    if mode in ("tf32", "tf32x"):
        out = out + mm(d(xh), d(wl)) + mm(d(xl), d(wh))
        if mode == "tf32x":
            out = out + mm(d(xl), d(wl))
    return out.float()


def jt_conv1x1_mid_exact(t, idx, count, wp, s1, mode, out, H, W):
    """``_jt_conv1x1_mid_plain`` with ``W2^T t`` summed exactly."""
    from .implicit_grad import _scaled

    n = int(count.item())
    mid = t.shape[1]
    y = _exact(t[:n].reshape(n, mid, H, W), wp[0], mode, F.conv2d)
    out[:n] = _scaled(y, s1.index_select(0, idx[:n].long())).reshape(n, mid, H * W)


def rv_wgrad_exact(a, ah, beta_a, b, bh, beta_b, bin_, shift, mode, part, H, W):
    """``_rv_wgrad_plain`` with each split's product summed exactly."""
    from .implicit_grad import _wgrad_operands, wgrad_splits

    A, Bm = _wgrad_operands(a, ah, beta_a, b, bh, beta_b, bin_, shift, H, W)
    S, kchunk = wgrad_splits(A.shape[0], Bm.shape[0], a.shape[0], H * W)
    if S != part.shape[0]:
        raise ValueError(f"part holds {part.shape[0]} splits, rv_wgrad makes {S}")
    for s in range(S):
        k = slice(s * kchunk, (s + 1) * kchunk)
        part[s] = _exact(A[:, k], Bm[:, k], mode, lambda x, y: x @ y.T)


def _conv3x3_exact(v, wp, mode):
    """The 3x3 conv (padding 1) of v by wp's kernel, summed exactly."""
    w = wp[0] if wp[1] is None else wp[0] + wp[1]  # splits again into (hi, lo)
    return _exact(v, w, mode, lambda x, k: F.conv2d(x, k, padding=1))


def rv_conv3x3_out_exact(t, th, beta_in, idx, count, wp, mode, out, H, W):
    """``_rv_conv3x3_out_plain`` with ``C1^T`` summed exactly."""
    n = int(count.item())
    mid = t.shape[1]
    v = (t[:n] * dswish(th[:n], beta_in)).reshape(n, mid, H, W)
    out[idx[:n].long()] = _conv3x3_exact(v, wp, mode).reshape(n, -1)


def _jt_conv3x3_out_by(product, t, idx, count, wp, s0, mode, base, sub, out, H, W):
    """``_jt_conv3x3_out_plain`` with ``product(t, wp, mode)`` for its 3x3
    conv; the residual ``base + y * s0 - sub`` rounded op by op in float32,
    as there."""
    n = int(count.item())
    e = idx[:n].long()
    mid = t.shape[1]
    y = product(t[:n].reshape(n, mid, H, W), wp, mode).flatten(1)
    out[e] = base.index_select(0, e) + y * s0.index_select(0, e) - sub.index_select(0, e)


def jt_conv3x3_out_exact(t, idx, count, wp, s0, mode, base, sub, out, H, W):
    """``_jt_conv3x3_out_plain`` with ``C1^T t`` summed exactly (all mid x 9
    terms in float64, rounded once)."""
    _jt_conv3x3_out_by(_conv3x3_exact, t, idx, count, wp, s0, mode, base, sub, out, H, W)


def _conv3x3_tiled(v, wp, mode):
    """The 3x3 mid -> c conv (padding 1) summed as the tensor-core kernel
    sums it: for each chunk of C3_MC channels, and within it each tap in
    order, a fresh float32 partial of the chunk's products, added to the
    sum (mode bf16: w rounded here; the split modes: wp's (hi, lo) used as
    they are, one partial and sum of hi*hi and one of hi*lo + lo*hi [+
    lo*lo], the two sums added last)."""
    if mode not in ("bf16",) + SPLIT_MODES:
        raise ValueError(f"the tensor cores' order is modes bf16, tf32 and tf32x's, not {mode!r}")
    split = mode in SPLIT_MODES
    vh, vl = _split(v.float(), mode)
    wh, wl = _widened(wp) if split else (_split(wp[0].float(), mode)[0], None)
    H, W = v.shape[2:]
    vph = F.pad(vh, (1, 1, 1, 1))
    vpl = F.pad(vl, (1, 1, 1, 1)) if split else None
    big = small = None
    add = lambda a, b: b if a is None else a + b
    for k0 in range(0, v.shape[1], C3_MC):
        k = slice(k0, k0 + C3_MC)
        for ky in range(3):
            for kx in range(3):
                tap = lambda x, w: F.conv2d(x[:, k, ky:ky + H, kx:kx + W],
                                            w[:, k, ky:ky + 1, kx:kx + 1])
                big = add(big, tap(vph, wh))
                if split:
                    part = tap(vph, wl) + tap(vpl, wh)
                    if mode == "tf32x":
                        part = part + tap(vpl, wl)
                    small = add(small, part)
    return big if small is None else big + small


def jt_conv3x3_out_tiled(t, idx, count, wp, s0, mode, base, sub, out, H, W):
    """``_jt_conv3x3_out_plain`` in mode bf16 with ``C1^T t`` summed in the
    tensor-core kernel's order (chunks of ``C3_MC`` channels, then taps)."""
    _jt_conv3x3_out_by(_conv3x3_tiled, t, idx, count, wp, s0, mode, base, sub, out, H, W)


def fp_conv_mid_exact(inp, inh, w, bias, beta_net, act, mode, out, H, W):
    """``_fp_conv_mid_plain`` with its product summed exactly."""
    from .fused_final import _fp_conv_by

    _fp_conv_by(lambda a, k, m: _exact(a, k, m, F.conv2d), inp, inh, w, bias, beta_net, act,
                mode, out, H, W)


def _tiled(a, k, mode):
    """The bf16 1x1 product summed by K tiles: each tile's products into a
    fresh float32 partial, the partials added in order."""
    if mode != "bf16":
        raise ValueError(f"the tensor cores' order is mode bf16's, not {mode!r}")
    ah, kh = _split(a.float(), mode)[0], _split(k.float(), mode)[0]
    acc = None
    for k0 in range(0, a.shape[1], TC_BK):
        part = F.conv2d(ah[:, k0:k0 + TC_BK], kh[:, k0:k0 + TC_BK])
        acc = part if acc is None else acc + part
    return acc


def fp_conv_mid_tiled(inp, inh, w, bias, beta_net, act, mode, out, H, W):
    """``_fp_conv_mid_plain`` in mode bf16 with its product summed in the
    tensor-core kernel's order (K tiles of ``TC_BK``)."""
    from .fused_final import _fp_conv_by

    _fp_conv_by(_tiled, inp, inh, w, bias, beta_net, act, mode, out, H, W)


def conv1x1_mid_exact(t1, count, wp, b2, beta2, mode, out, H, W):
    """``_conv1x1_mid_plain`` with its product summed exactly (every pass of
    the split in float64, rounded once), then ``+ b2`` and swish as there;
    wp the kernel's (hi, lo), used as it is."""
    n = int(count.item())
    mid = t1.shape[1]
    y = _exact(t1[:n].reshape(n, mid, H, W), tuple(wp), mode, F.conv2d)
    out[:n] = swish(y + b2[None, :, None, None], beta2).reshape(n, mid, H * W)


def _split_tiled(x, wp, mode):
    """The split modes' 1x1 product summed as the tensor-core kernel sums
    it: per K tile a fresh float32 partial of hi*hi and one of hi*lo + lo*hi
    (+ lo*lo), each added to its float32 sum; then the two sums added."""
    xh, xl = _split(x.float(), mode)
    wh, wl = _widened(wp)
    big = small = None
    add = lambda a, b: b if a is None else a + b
    for k0 in range(0, x.shape[1], TC_BK):
        k = slice(k0, k0 + TC_BK)
        big = add(big, F.conv2d(xh[:, k], wh[:, k]))
        part = F.conv2d(xl[:, k], wh[:, k]) + F.conv2d(xh[:, k], wl[:, k])
        if mode == "tf32x":
            part = part + F.conv2d(xl[:, k], wl[:, k])
        small = add(small, part)
    return big + small


def conv1x1_mid_tiled(t1, count, wp, b2, beta2, mode, out, H, W):
    """``conv1x1_mid`` as its wrapper routes it: in mode tf32 / tf32x
    ``_conv1x1_mid_plain`` with its product summed as the tensor-core kernel
    sums it (:func:`_split_tiled`; then ``+ b2`` and swish); in modes f32 /
    bf16, which stay on the CUDA cores, the plain version."""
    if mode not in SPLIT_MODES:
        return _conv1x1_mid_plain(t1, count, wp, b2, beta2, mode, out, H, W)
    n = int(count.item())
    mid = t1.shape[1]
    y = _split_tiled(t1[:n].reshape(n, mid, H, W), wp, mode)
    out[:n] = swish(y + b2[None, :, None, None], beta2).reshape(n, mid, H * W)


def _lin_conv1x1_mid_by(product, t1, wp, b2, beta2, mode, out, s2, H, W):
    """``_lin_conv1x1_mid_plain`` with ``product(t1, wp, mode)`` for its 1x1
    product (b2, swish and swish' after it, as there)."""
    B, mid, _ = t1.shape
    h2 = product(t1.reshape(B, mid, H, W), tuple(wp), mode) + b2[None, :, None, None]
    out.copy_(swish(h2, beta2).reshape(out.shape))
    s2.copy_(dswish(h2, beta2).reshape(s2.shape))


def lin_conv1x1_mid_exact(t1, wp, b2, beta2, mode, out, s2, H, W):
    """``_lin_conv1x1_mid_plain`` with its product summed exactly (every pass
    of the split in float64, rounded once); wp the kernel's (hi, lo)."""
    _lin_conv1x1_mid_by(lambda x, w, m: _exact(x, w, m, F.conv2d), t1, wp, b2, beta2, mode,
                        out, s2, H, W)


def lin_conv1x1_mid_tiled(t1, wp, b2, beta2, mode, out, s2, H, W):
    """``lin_conv1x1_mid`` as its wrapper routes it: in mode tf32 / tf32x
    ``_lin_conv1x1_mid_plain`` with its product summed as the tensor-core
    kernel sums it (:func:`_split_tiled`); in modes f32 / bf16, which stay
    on the CUDA cores, the plain version."""
    from .fused_block import _lin_conv1x1_mid_plain

    if mode not in SPLIT_MODES:
        return _lin_conv1x1_mid_plain(t1, wp, b2, beta2, mode, out, s2, H, W)
    _lin_conv1x1_mid_by(_split_tiled, t1, wp, b2, beta2, mode, out, s2, H, W)


def _rv_conv1x1_mid_by(product, inp, inh, count, wp, bias, alpha, beta_in, act, mode,
                       out, H, W):
    """``_rv_conv1x1_mid_plain`` with ``product(a, wp, mode)`` for its 1x1
    product (alpha and the bias applied after it, as there)."""
    from .implicit_grad import _act, _affine

    n = int(count.item())
    mid = inp.shape[1]
    a = _act(inp[:n], inh[:n], beta_in, act).reshape(n, mid, H, W)
    out[:n] = _affine(product(a, tuple(wp), mode), alpha, bias).reshape(n, mid, H * W)


def rv_conv1x1_mid_exact(inp, inh, count, wp, bias, alpha, beta_in, act, mode, out, H, W):
    """``_rv_conv1x1_mid_plain`` with its product summed exactly."""
    _rv_conv1x1_mid_by(lambda a, w, m: _exact(a, w, m, F.conv2d), inp, inh, count, wp,
                       bias, alpha, beta_in, act, mode, out, H, W)


def rv_conv1x1_mid_tiled(inp, inh, count, wp, bias, alpha, beta_in, act, mode, out, H, W):
    """``_rv_conv1x1_mid_plain`` in mode bf16 with its product summed in the
    tensor-core kernel's order (K tiles of ``TC_BK``)."""
    _rv_conv1x1_mid_by(lambda a, w, m: _tiled(a, w[0].float(), m), inp, inh, count, wp,
                       bias, alpha, beta_in, act, mode, out, H, W)


def _conv3x3_in_exact(x, w, mode):
    """The 3x3 conv (padding 1) of x by w (one kernel, or a (hi, lo) pair
    used as it is), every pass of the mode summed exactly (either
    direction: also the solve's mid -> c conv3x3_out)."""
    return _exact(x, tuple(w) if isinstance(w, (tuple, list)) else w.float(), mode,
                  lambda a, k: F.conv2d(a, k, padding=1))


def _conv3x3_in_tiled(x, w, mode):
    """The 3x3 c -> mid conv (padding 1) of x by w (one kernel, split here,
    or a (hi, lo) pair) summed as the tensor-core kernel sums it: over the
    im2col's k = ci * 9 + ky * 3 + kx, each K tile of C3I_BK into a fresh
    float32 partial added to its sum (in the split modes one of hi*hi and
    one of hi*lo + lo*hi [+ lo*lo]; the two sums added last)."""
    if mode not in ("bf16",) + SPLIT_MODES:
        raise ValueError(f"the tensor cores' order is modes bf16, tf32 and tf32x's, not {mode!r}")
    B, c, H, W = x.shape
    xh, xl = _split(x.float(), mode)
    wh, wl = _widened(w) if isinstance(w, (tuple, list)) else _split(w.float(), mode)
    M = wh.shape[0]
    cols = lambda t: F.unfold(t, 3, padding=1)  # (B, 9 c, H W), k = ci * 9 + tap
    xh, wh = cols(xh), wh.reshape(M, -1)
    if mode in SPLIT_MODES:
        xl, wl = cols(xl), wl.reshape(M, -1)
    big = small = None
    add = lambda a, b: b if a is None else a + b
    for k0 in range(0, 9 * c, C3I_BK):
        k = slice(k0, k0 + C3I_BK)
        big = add(big, wh[:, k] @ xh[:, k])
        if mode in SPLIT_MODES:
            part = wh[:, k] @ xl[:, k] + wl[:, k] @ xh[:, k]
            if mode == "tf32x":
                part = part + wl[:, k] @ xl[:, k]
            small = add(small, part)
    y = big if small is None else big + small
    return y.reshape(B, M, H, W)


def nc_jt_in_exact(u, w3t, s2, mode, out):
    """``_nc_jt_in_plain`` with ``C3^T u`` summed exactly (all c x 9 terms
    in float64, rounded once)."""
    from .fused_chain import _nc_jt_in_by

    _nc_jt_in_by(_conv3x3_in_exact, u, w3t, s2, mode, out)


def nc_jt_in_tiled(u, w3t, s2, mode, out):
    """``nc_jt_in`` as its wrapper routes it: in mode bf16
    ``_nc_jt_in_plain`` with ``C3^T u`` summed in the tensor-core kernel's
    order (K tiles of ``C3I_BK``); in mode f32, which stays on the CUDA
    cores, the plain version."""
    from .fused_chain import _nc_jt_in_by, _nc_jt_in_plain

    if mode != "bf16":
        return _nc_jt_in_plain(u, w3t, s2, mode, out)
    _nc_jt_in_by(_conv3x3_in_tiled, u, w3t, s2, mode, out)


def lin_conv3x3_in_exact(inp, wp, b1, betas, preact, mode, out, s1, s0):
    """``_lin_conv3x3_in_plain`` with its product summed exactly (every pass
    of the split in float64, rounded once); wp the kernel's (hi, lo)."""
    from .fused_block import _lin_conv3x3_in_by

    _lin_conv3x3_in_by(_conv3x3_in_exact, inp, wp, b1, betas, preact, mode, out, s1, s0)


def lin_conv3x3_in_tiled(inp, wp, b1, betas, preact, mode, out, s1, s0):
    """``lin_conv3x3_in`` as its wrapper routes it: in mode tf32 / tf32x
    ``_lin_conv3x3_in_plain`` with its product summed as the tensor-core
    kernel sums it (K tiles of ``C3I_BK``); in modes f32 / bf16, which stay
    on the CUDA cores, the plain version."""
    from .fused_block import _lin_conv3x3_in_by, _lin_conv3x3_in_plain

    if mode not in SPLIT_MODES:
        return _lin_conv3x3_in_plain(inp, wp, b1, betas, preact, mode, out, s1, s0)
    _lin_conv3x3_in_by(_conv3x3_in_tiled, inp, wp, b1, betas, preact, mode, out, s1, s0)


def conv3x3_in_exact(inp, idx, count, wp, b1, betas, preact, mode, out):
    """``_conv3x3_in_plain`` with its product summed exactly (every pass of
    the split in float64, rounded once); wp the kernel's (hi, lo)."""
    _conv3x3_in_by(_conv3x3_in_exact, inp, idx, count, wp, b1, betas, preact, mode, out)


def conv3x3_in_tiled(inp, idx, count, wp, b1, betas, preact, mode, out):
    """``conv3x3_in`` as its wrapper routes it: in mode tf32 / tf32x
    ``_conv3x3_in_plain`` with its product summed as the tensor-core kernel
    sums it (K tiles of ``C3I_BK``, hi*hi apart from the small passes); in
    modes f32 / bf16, which stay on the CUDA cores, the plain version."""
    if mode not in SPLIT_MODES:
        return _conv3x3_in_plain(inp, idx, count, wp, b1, betas, preact, mode, out)
    _conv3x3_in_by(_conv3x3_in_tiled, inp, idx, count, wp, b1, betas, preact, mode, out)


def nc_jt_out_acc_exact(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W):
    """``_nc_jt_out_acc_plain`` with ``C1^T t`` summed exactly (all mid x 9
    terms in float64, rounded once)."""
    from .fused_chain import _nc_jt_out_acc_by

    _nc_jt_out_acc_by(_conv3x3_exact, t, w1t, s0, mode, coeffs, k, u_out, acc, H, W)


def nc_jt_out_acc_tiled(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W):
    """``nc_jt_out_acc`` as its wrapper routes it: in mode bf16
    ``_nc_jt_out_acc_plain`` with ``C1^T t`` summed in the tensor-core
    kernel's order (chunks of ``C3_MC`` channels, then taps, each into a
    fresh float32 partial); in mode f32, which stays on the CUDA cores, the
    plain version."""
    from .fused_chain import _nc_jt_out_acc_by, _nc_jt_out_acc_plain

    if mode != "bf16":
        return _nc_jt_out_acc_plain(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W)
    _nc_jt_out_acc_by(_conv3x3_tiled, t, w1t, s0, mode, coeffs, k, u_out, acc, H, W)


def fp_conv_out_exact(t, w, mode, out, H, W, nets=None):
    """``_fp_conv_out_plain`` with ``C1^T t`` summed exactly (all mid x 9
    terms in float64, rounded once)."""
    from .fused_final import _fp_conv_out_by

    _fp_conv_out_by(_conv3x3_exact, t, w, mode, out, H, W, nets)


def fp_conv_out_tiled(t, w, mode, out, H, W, nets=None):
    """``fp_conv_out`` as its wrapper routes it: in mode bf16
    ``_fp_conv_out_plain`` with ``C1^T t`` summed in the tensor-core
    kernel's order (chunks of ``C3_MC`` channels, then taps, each into a
    fresh float32 partial); in mode f32, which stays on the CUDA cores, the
    plain version."""
    from .fused_final import _fp_conv_out_by, _fp_conv_out_plain

    if mode != "bf16":
        return _fp_conv_out_plain(t, w, mode, out, H, W, nets)
    _fp_conv_out_by(_conv3x3_tiled, t, w, mode, out, H, W, nets)


def jt_conv3x3_in_exact(u, idx, count, wp, s2, mode, out):
    """``_jt_conv3x3_in_plain`` with ``C3^T u`` summed exactly (all c x 9
    terms in float64, rounded once)."""
    from .implicit_grad import _jt_conv3x3_in_by

    _jt_conv3x3_in_by(lambda x, w, m: _conv3x3_in_exact(x, w[0], m), u, idx, count, wp, s2,
                      mode, out)


def jt_conv3x3_in_tiled(u, idx, count, wp, s2, mode, out):
    """``jt_conv3x3_in`` as its wrapper routes it: in mode bf16
    ``_jt_conv3x3_in_plain`` with ``C3^T u`` summed in the tensor-core
    kernel's order (K tiles of ``C3I_BK``); in mode f32, which stays on the
    CUDA cores, the plain version."""
    from .implicit_grad import _jt_conv3x3_in_by, _jt_conv3x3_in_plain

    if mode != "bf16":
        return _jt_conv3x3_in_plain(u, idx, count, wp, s2, mode, out)
    _jt_conv3x3_in_by(lambda x, w, m: _conv3x3_in_tiled(x, w[0], m), u, idx, count, wp, s2,
                      mode, out)


def fp_conv_in_exact(inp, inh, w, bias, beta_net, act, mode, out):
    """``_fp_conv_in_plain`` with each net's product summed exactly (all c x
    9 terms in float64, rounded once); the transform and the bias as
    there."""
    from .fused_final import _fp_conv_by

    _fp_conv_by(_conv3x3_in_exact, inp, inh, w, bias, beta_net, act, mode, out,
                *inp.shape[2:])


def rv_conv3x3_in_exact(inp, idx, count, wp, bias, alpha, beta_in, act, mode, out):
    """``_rv_conv3x3_in_plain`` with its product summed exactly (every pass
    of the split in float64, rounded once); wp the kernel's (hi, lo)."""
    from .implicit_grad import _rv_conv3x3_in_by

    _rv_conv3x3_in_by(lambda h, w, m: _conv3x3_in_exact(h, tuple(w), m), inp, idx, count, wp,
                      bias, alpha, beta_in, act, mode, out)


def fp_conv_in_tiled(inp, inh, w, bias, beta_net, act, mode, out):
    """``_fp_conv_in_plain`` in mode bf16 with each net's product summed in
    the order of the c -> mid kernel's ``EPI_AFFINE`` (K tiles of
    ``C3I_BK``), which the final pair's float64 form does not take; the
    transform and the bias as there."""
    from .fused_final import _fp_conv_by

    _fp_conv_by(_conv3x3_in_tiled, inp, inh, w, bias, beta_net, act, mode, out,
                *inp.shape[2:])


def rv_conv3x3_in_tiled(inp, idx, count, wp, bias, alpha, beta_in, act, mode, out):
    """``rv_conv3x3_in`` as its wrapper routes it: in mode bf16
    ``_rv_conv3x3_in_plain`` with its product summed in the tensor-core
    kernel's order (K tiles of ``C3I_BK``); in modes f32 / tf32, which stay
    on the CUDA cores, the plain version."""
    from .implicit_grad import _rv_conv3x3_in_by, _rv_conv3x3_in_plain

    if mode != "bf16":
        return _rv_conv3x3_in_plain(inp, idx, count, wp, bias, alpha, beta_in, act, mode, out)
    _rv_conv3x3_in_by(lambda h, w, m: _conv3x3_in_tiled(h, w[0], m), inp, idx, count, wp,
                      bias, alpha, beta_in, act, mode, out)


def conv3x3_out_exact(t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W):
    """``_conv3x3_out_plain`` with ``W3 t`` summed exactly (every pass of the
    split, all mid x 9 terms, in float64, rounded once); wp as the wrapper
    takes it (:func:`~.fused_solve.prep_conv3x3_out`), its (hi, lo) used as
    they are."""
    _conv3x3_out_by(_conv3x3_in_exact, t2, idx, count, wp, b3, mode, base, sgn, sub, out, H,
                    W)


def conv3x3_out_tiled(t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W):
    """``conv3x3_out`` as its wrapper routes it: in mode tf32 / tf32x
    ``_conv3x3_out_plain`` with ``W3 t`` summed in the tensor-core kernel's
    order (chunks of ``C3_MC`` channels, then taps, each into fresh float32
    partials, hi*hi apart from the small passes); in modes f32 / bf16, which
    stay on the CUDA cores, the plain version."""
    if mode not in SPLIT_MODES:
        return _conv3x3_out_plain(t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W)
    _conv3x3_out_by(_conv3x3_tiled, t2, idx, count, wp, b3, mode, base, sgn, sub, out, H, W)


# ---------------------------------------------------------------------------
# the reductions of the Broyden update, the final pair's T and the
# re-attachment's channel sums

def _cluster_tree(p, cluster, threads, vpt, vec=4):
    """Each row of ``p`` (..., n) summed as the cluster-split reductions of
    ``csrc/cluster_reduce.cuh`` sum it: CTA r of ``cluster`` takes elements
    [r n / cluster, (r + 1) n / cluster) as vectors of ``vec`` floats
    (float4 where 4), thread t of ``threads`` the vectors t + m threads (m <
    ``vpt``) into one float32 sum, each vector's lanes in order; a warp adds
    its lanes by the xor butterfly (offsets 16 .. 1), the CTA its warps in
    order, the cluster its CTAs in order, each sum from 0."""
    *lead, n = p.shape
    nv = n // cluster // vec
    P = F.pad(p.reshape(*lead, cluster, nv, vec), (0, 0, 0, vpt * threads - nv))
    P = P.reshape(*lead, cluster, vpt, threads, vec)
    acc = torch.zeros(*lead, cluster, threads, dtype=p.dtype, device=p.device)
    for m in range(vpt):
        for lane in range(vec):
            acc = acc + P[..., m, :, lane]
    acc = acc.reshape(*lead, cluster, threads // 32, 32)
    lanes = torch.arange(32, device=p.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    warps = acc[..., 0]
    cta = torch.zeros(*lead, cluster, dtype=p.dtype, device=p.device)
    for w in range(warps.shape[-1]):
        cta = cta + warps[..., w]
    out = torch.zeros(*lead, dtype=p.dtype, device=p.device)
    for r in range(cluster):
        out = out + cta[..., r]
    return out


class _ExactSums:
    """``broyden_step``'s sums in float64, each rounded once."""

    @staticmethod
    def norm(v):
        return torch.linalg.vector_norm(v.double(), dim=1).to(v.dtype)

    @staticmethod
    def contract(planes, vec, live):
        return torch.where(live, torch.einsum("nkd,nd->nk", planes.double(),
                                              vec.double()).to(vec.dtype), 0.0)

    @staticmethod
    def combine(coef, planes, live):
        return torch.einsum("nk,nkd->nd", coef.double(), planes.double()).to(planes.dtype)

    @staticmethod
    def dot(a, b):
        return (a.double() * b.double()).sum(1, keepdim=True).to(a.dtype)


class _TiledSums:
    """``broyden_step``'s sums as its kernel (``csrc/broyden_step.cu``)
    takes them: over D the cluster's tree (:func:`_cluster_tree` on the
    plan of :func:`~.fused_solve.broyden_plan`), over k in order from 0,
    each example's k < nk only."""

    @staticmethod
    def _tree(p):
        plan = broyden_plan(p.shape[-1], 1)
        return _cluster_tree(p, plan.cluster, plan.threads, plan.vpt)

    @classmethod
    def norm(cls, v):
        return torch.sqrt(cls._tree(v * v))

    @classmethod
    def contract(cls, planes, vec, live):
        return torch.where(live, cls._tree(planes * vec[:, None, :]), 0.0)

    @staticmethod
    def combine(coef, planes, live):
        acc = planes.new_zeros(planes.shape[0], planes.shape[2])
        for k in range(planes.shape[1]):
            acc = torch.where(live[:, k:k + 1], acc + coef[:, k:k + 1] * planes[:, k], acc)
        return acc

    @classmethod
    def dot(cls, a, b):
        return cls._tree(a * b)[:, None]


def broyden_step_exact(phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw):
    """``_broyden_step_plain`` with every contraction over D and over k,
    the norm and the two dot products summed in float64 and rounded once."""
    _broyden_step_by(_ExactSums, phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw)


def broyden_step_tiled(phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw):
    """``_broyden_step_plain`` with its sums in the cluster kernel's order
    (:class:`_TiledSums`); every other operation as the plain version."""
    _broyden_step_by(_TiledSums, phase, idx_in, cnt_in, idx_out, cnt_out, st, **kw)


class _UpdateTiledSums(_TiledSums):
    """``broyden_update``'s sums as its kernel (``csrc/broyden_update.cu``)
    takes them: over D in the order of the form that
    :func:`~.broyden_update.update_plan` picks (the warp form: one warp's
    tree over elements lane + 32 m; the cluster form: the cluster's tree
    over float4 vectors, the row padded with zeros to the plan's slices),
    over k in order from 0."""

    @staticmethod
    def _tree(p):
        D = p.shape[-1]
        plan = update_plan(D)
        if plan.cluster == 0:
            return _cluster_tree(p, 1, 32, plan.vpt, vec=1)
        n = 4 * plan.cluster * plan.slice
        return _cluster_tree(F.pad(p, (0, n - D)), plan.cluster, plan.threads, plan.vpt)


def broyden_update_exact(UTs, VTs, delta_x, delta_gx, gx, active, col):
    """``broyden_update_plain`` with every contraction over D and over k
    and both dot products summed in float64 and rounded once."""
    return _broyden_update_by(_ExactSums, UTs, VTs, delta_x, delta_gx, gx, active, col)


def broyden_update_tiled(UTs, VTs, delta_x, delta_gx, gx, active, col):
    """``broyden_update_plain`` with its sums in its kernel's order
    (:class:`_UpdateTiledSums`); every other operation as the plain
    version."""
    return _broyden_update_by(_UpdateTiledSums, UTs, VTs, delta_x, delta_gx, gx, active, col)


def fp_tdot_exact(r, h, th, beta_net, out):
    """``_fp_tdot_plain`` with each example's products summed in float64 and
    rounded once."""
    _fp_tdot_by(lambda p: p.double().sum(1).to(p.dtype), r, h, th, beta_net, out)


def fp_tdot_tiled(r, h, th, beta_net, out):
    """``_fp_tdot_plain`` with each example's products summed in the cluster
    kernel's order (``csrc/tdot.cu``: :func:`_cluster_tree` on the plan of
    :func:`~.fused_final.tdot_plan` at an H100's SMs, 256 threads a CTA)."""
    cluster, chunk = tdot_plan(r.shape[0], r[0].numel())
    vpt = -(-chunk // 4 // TDOT_THREADS)
    _fp_tdot_by(lambda p: _cluster_tree(p, cluster, TDOT_THREADS, vpt), r, h, th, beta_net,
                out)


def rv_chan_sums_exact(t, h, beta, alpha, base, sums, dbeta, out):
    """``_rv_chan_sums_plain`` with each channel's terms summed in float64
    and rounded once."""
    _rv_chan_sums_by(lambda p: p.double().sum(1).to(p.dtype), t, h, beta, alpha, base, sums,
                     dbeta, out)


def rv_chan_sums_tiled(t, h, beta, alpha, base, sums, dbeta, out):
    """``_rv_chan_sums_plain`` with each channel's terms summed in the
    cluster kernel's order (``csrc/chan_sums.cu``: :func:`_cluster_tree` on
    the plan of :func:`~.implicit_grad.chan_sums_plan` at an H100's SMs,
    CS_THREADS threads a CTA, the vectors the tensors' alignment allows)."""
    Bn, M, HW = t.shape
    plan = chan_sums_plan(M, Bn, HW, _chan_sums_vec(t, h, base, out))
    vpt = -(-plan.chunk // plan.vec // CS_THREADS)
    _rv_chan_sums_by(lambda p: _cluster_tree(p, plan.cluster, CS_THREADS, vpt, plan.vec), t, h,
                     beta, alpha, base, sums, dbeta, out)


def line_search_exact(phase, st, ls, idx=None, cnt=None):
    """``_line_search_plain`` with each sum of squares in float64, rounded
    once."""
    _line_search_by(lambda v: (v.double() * v.double()).sum(1).to(v.dtype), phase, st, ls, idx,
                    cnt)


def line_search_tiled(phase, st, ls, idx=None, cnt=None):
    """``_line_search_plain`` with each sum of squares in the cluster
    kernel's order (``csrc/line_search.cu``: :func:`_cluster_tree` on the
    plan of :func:`~.fused_solve.broyden_plan`, as broyden_step's)."""
    _line_search_by(lambda v: _TiledSums._tree(v * v), phase, st, ls, idx, cnt)
