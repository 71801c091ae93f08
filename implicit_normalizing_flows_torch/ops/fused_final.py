"""The Neumann estimator's differentiable final term of both nets with its
CUDA kernels: ``T = <acc, J_g(h) eps>`` and its second-order backward.

Port of ``ops/fused_solve.py::fused_final_pair`` of the JAX package (TPU
kernel at ``fused_solve.py:1689``; ``_final_primal_kernel`` :1440 and
``_final_T_in_kernel`` :1346, ``_final_bwd_kernel`` :1478 and
``_final_grads_in_kernel`` :1372, ``_make_fused_final_pair`` :1532). The TPU
kernels hold one example's forward and tangent intermediates in VMEM and sum
the weight gradients across the sequential grid; on Hopper both directions
are sequences of batched kernels of ``csrc/estimator.cu`` on the conv
templates of ``csrc/conv_gemm.cuh`` (in mode bf16 every product on the
tensor cores: ``fp_conv_in`` on the c -> mid kernel's float64 form
(``csrc/conv3x3_in_tc.cuh``'s ``conv3x3_in_dmma_kernel``, the FP64 tensor
cores summing the exact bf16 products in float64), with W1 and W3^T cast to bfloat16 once by
:func:`_weights`; ``fp_conv_mid`` on ``csrc/mma_gemm.cuh``,
with W2 and W2^T cast the same way; ``fp_conv_out`` on the mid -> c kernel,
``csrc/conv3x3_out_tc.cuh``, with W1^T cast once into its tile layout), the
two nets' examples stacked along the batch so that one launch covers both:

* primal: ``fp_conv_in`` (``h1 = W1 a0 + b1``, ``th1 = W1 ta0``,
  ``r2 = C3^T acc``), ``fp_conv_mid`` (``h2 = W2 swish(h1) + b2``,
  ``th2 = W2 (swish'(h1) th1)``), ``fp_tdot`` (``T = sum r2 swish'(h2)
  th2`` per example; its own unit ``csrc/tdot.cu``, a thread-block cluster
  an example, :func:`tdot_plan`), with ``a0 = swish(h; b0)``, ``ta0 =
  swish'(h; b0) eps`` under preact and ``a0 = h``, ``ta0 = eps`` without;
* backward (recomputes the primal's intermediates, as the TPU kernel
  does): ``fp_second`` (``rh = swish' r``, ``p = [swish' q] + swish'' th r``
  and the channel sums that give db and dbeta), ``fp_conv_mid`` with W2^T
  on ``rh2`` and ``p_h2`` together, ``fp_conv_out`` (``C1^T``, on ``rh1``
  and ``p_h1`` together under preact), and the weight gradients ``dW3 = acc
  x shift(ta2)``, ``dW2 = rh2 x ta1 + p_h2 x a1``, ``dW1 = rh1 x shift(ta0) +
  p_h1 x shift(a0)`` as split-K partials of the re-attachment's
  ``rv_wgrad`` (``ops/implicit_grad.py``; a pair's two products into one
  partial buffer) summed in fixed order by its ``rv_wgrad_reduce``.

:func:`fused_final_pair` is a ``torch.autograd.Function``: its gradients go
to both nets' effective tensors of ``conv_forward_data`` (``DATA_KEYS``; b3's
is exactly zero, betas' is ``[db0, db1, db2]`` with ``db0 = 0`` without
preact) and to x and z, from which autograd pulls them back to the raw
parameters and into the implicit gradient; eps and acc are constants. The
per-example cotangent is folded into acc (``fused_solve.py:1638-1644``).
Mode 'bf16' rounds both operands of every product to bfloat16 and sums in
float32, 'f32' is exact float32; the elementwise math is float32.

The plain versions are the same hand-derived math in plain PyTorch ops (not
autograd's double backward: torch's CPU bfloat16 conv differentiates its own
VJP wrongly). Each wrapper launches its kernel for CUDA tensors and runs its
plain version for CPU tensors; a CUDA tensor never falls back. Each wrapper
counts its launches in ``<wrapper>.launches``. :func:`fused_final_pair_plain`
forces the plain versions on any device. The nets of one call must share
``preact`` (both nets of a block are built alike).
"""
from __future__ import annotations

import ctypes

import torch

from . import implicit_grad as ig
from .fused_chain import _nets, c3_out_npad, tile_w1t, untile_w1t
from .fused_solve import (C3_MID, C3_OUT_ROWS, MODES, _check_aligned, _check_cuda, _launch,
                          _mconv, _ptr, check_conv3x3_tc, conv3x3_in_rows, d2swish,
                          ddswish_dbeta, dswish, dswish_dbeta, prep_weight, swish)
from .implicit_grad import (ACTS, DATA_KEYS, _check_mid, _shapes, _sms, transpose_weights,
                            wgrad_splits)

__all__ = ["fused_final_pair", "fused_final_pair_plain", "FINAL_MODES", "tdot_plan",
           "KERNELS", "launch_counts", "reset_launch_counts"]

FINAL_MODES = ("f32", "bf16")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "imnf_fp_conv_in": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "imnf_fp_conv_mid": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "imnf_fp_conv_out": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "imnf_fp_tdot": [_P, _P, _P, _P, _I, _I, _L, _I, _L, _P, _P],
    "imnf_fp_second": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}


def _lib():
    from . import cuda_build

    lib = cuda_build.load("estimator")
    for fn, args in _ARGTYPES.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _run(fn, *args):
    _launch(fn, *args, lib=_lib())


def _mode(mode):
    if mode not in FINAL_MODES:
        raise ValueError(f"precision mode {mode!r} not taken here; valid: {FINAL_MODES}")
    return MODES[mode]


def _act(x, h, beta, act):
    if act == "swish":
        return swish(x, beta)
    if act == "dswish":
        return x * dswish(h, beta)
    if act != "id":
        raise ValueError(f"act {act!r}: 'id' | 'swish' | 'dswish'")
    return x


# ---------------------------------------------------------------------------
# the kernels' wrappers. Examples of N nets stacked along the batch (N*nb);
# weights stacked per net (N, O, I, k, k), biases (N, O), slopes beta_net a
# device vector (N,) of float32.

def _fp_conv_by(product, inp, inh, w, bias, beta_net, act, mode, out, H, W):
    """fp_conv_in's and fp_conv_mid's function with ``product(a, w[n],
    mode)`` for each net's product (w[n] widened to float32; the bias added
    after it)."""
    N, nb = _nets(w, inp.shape[0])
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        x = inp[e].reshape(nb, -1, H, W)
        hh = None if inh is None else inh[e].reshape(x.shape)
        y = product(_act(x, hh, None if beta_net is None else beta_net[n], act),
                    w[n].to(x.dtype), mode)
        if bias is not None:
            y = y + bias[n][None, :, None, None]
        out[e] = y.reshape(out[e].shape)


def _fp_conv_plain(inp, inh, w, bias, beta_net, act, mode, out, H, W, padding):
    _fp_conv_by(lambda a, k, m: _mconv(a, (k, None), m, padding), inp, inh, w, bias, beta_net,
                act, mode, out, H, W)


def _fp_conv(name, inp, inh, w, bias, beta_net, act, mode, out, H, W, mid):
    """The CUDA launch of fp_conv_in / fp_conv_mid."""
    Bt = inp.shape[0]
    N, _ = _nets(w, Bt)
    if act not in ACTS:
        raise ValueError(f"act {act!r}: 'id' | 'swish' | 'dswish'")
    if act != "id" and beta_net is None:
        raise ValueError(f"act {act!r} needs beta_net")
    if act == "dswish" and inh is None:
        raise ValueError("act 'dswish' needs inh")
    _check_cuda(inp=inp, inh=inh, bias=bias, beta_net=beta_net, out=out)
    _shapes(inh=(inh, inp.shape), bias=(bias, (N, mid)),
            beta_net=(beta_net, (N,)), out=(out, (Bt, mid, H * W)))
    args = [_mode(mode), ACTS[act], _ptr(w), _ptr(bias), _ptr(beta_net), _ptr(inp),
            _ptr(inh), Bt, N]
    if name == "imnf_fp_conv_in":
        args += [inp.shape[1], H, W, mid]
    else:
        args += [mid, H, W]
    _run(name, *args, _ptr(out))


def _fp_conv_in_plain(inp, inh, w, bias, beta_net, act, mode, out):
    _fp_conv_plain(inp, inh, w, bias, beta_net, act, mode, out, *inp.shape[2:], 1)


def fp_conv_in(inp, inh, w, bias, beta_net, act, mode, out):
    """out = W[n] act(inp) [+ bias[n]], a 3x3 conv c -> mid per net n:
    act 'id', 'swish' (slope beta_net[n]) or 'dswish' (inp * swish'(inh)).
    inp, inh (N*nb, c, H, W); w (N, mid, c, 3, 3) as :func:`_weights` casts
    it: bfloat16 in mode bf16, which runs on the tensor cores
    (``csrc/conv3x3_in_tc.cuh``'s float64 form: the exact products summed in
    float64 on the FP64 tensor cores) and takes what
    :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with a
    16-byte aligned out; float32 in mode f32. out (N*nb, mid, H*W)."""
    _, c, H, W = inp.shape
    if not inp.is_cuda:
        return _fp_conv_in_plain(inp, inh, w, bias, beta_net, act, mode, out)
    _check_cuda(_dtypes=(torch.bfloat16 if mode == "bf16" else torch.float32,), w=w)
    if mode == "bf16":
        check_conv3x3_tc("fp_conv_in", c, w.shape[1], H, W, conv3x3_in_rows(W), out=out)
    _shapes(w=(w, (w.shape[0], w.shape[1], c, 3, 3)))
    _fp_conv("imnf_fp_conv_in", inp, inh, w, bias, beta_net, act, mode, out, H, W,
             w.shape[1])
    fp_conv_in.launches += 1


def _fp_conv_mid_plain(inp, inh, w, bias, beta_net, act, mode, out, H, W):
    _fp_conv_plain(inp, inh, w, bias, beta_net, act, mode, out, H, W, 0)


def fp_conv_mid(inp, inh, w, bias, beta_net, act, mode, out, H, W):
    """out = W[n] act(inp) [+ bias[n]], a 1x1 conv mid -> mid per net;
    inp, inh, out (N*nb, mid, H*W); w (N, mid, mid, 1, 1) as
    :func:`_weights` casts it: bfloat16 in mode bf16, which runs on the
    tensor cores (``csrc/mma_gemm.cuh``), float32 in mode f32."""
    if not inp.is_cuda:
        return _fp_conv_mid_plain(inp, inh, w, bias, beta_net, act, mode, out, H, W)
    mid = inp.shape[1]
    _check_mid(w, mode, mid, H * W, inp=inp, inh=inh, out=out)
    _shapes(inp=(inp, (inp.shape[0], mid, H * W)), w=(w, (w.shape[0], mid, mid, 1, 1)))
    _fp_conv("imnf_fp_conv_mid", inp, inh, w, bias, beta_net, act, mode, out, H, W,
             mid)
    fp_conv_mid.launches += 1


def _fp_conv_out_by(product, t, w, mode, out, H, W, nets=None):
    """``fp_conv_out``'s function with ``product(x, wp, mode)`` for each
    net's 3x3 product (wp that net's OIHW kernel, unpacked from the tile
    layout where it comes so): net n of the ``nets`` stacked along t's
    batch takes the kernel of net n modulo the nets w holds."""
    Bt, mid = t.shape[:2]
    w = untile_w1t(w, out[0].numel() // (H * W), mid)
    N = w.shape[0] if nets is None else nets
    if N % w.shape[0]:
        raise ValueError(f"{N} nets do not repeat the {w.shape[0]} nets of the kernels")
    nb = Bt // N
    if Bt % N:
        raise ValueError(f"{Bt} examples do not split over {N} nets")
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        y = product(t[e].reshape(nb, mid, H, W), (w[n % w.shape[0]].to(t.dtype), None), mode)
        out[e] = y.reshape(out[e].shape)


def _fp_conv_out_plain(t, w, mode, out, H, W, nets=None):
    _fp_conv_out_by(lambda x, wp, m: _mconv(x, wp, m, 1), t, w, mode, out, H, W, nets)


def fp_conv_out(t, w, mode, out, H, W, nets=None):
    """out = C[n] t, a 3x3 conv mid -> c per net n (C1^T with the flipped
    w1). t (nets*nb, mid, H*W); out (nets*nb, c*H*W); net n takes the
    kernel of net n modulo the N nets w holds (``nets`` a multiple of N, N
    by default: under preact the backward's rh1 and p_h1 of both nets are
    four "nets" on two nets' kernels). w as :func:`_weights` makes it: in
    mode bf16 :func:`~.fused_chain.tile_w1t`'s layout (N, mid / 64, 9 npad,
    64) bfloat16, which runs on the tensor cores
    (``csrc/conv3x3_out_tc.cuh``) and takes what
    :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with 16-byte
    aligned t and w; in mode f32 (N, c, mid, 3, 3) float32."""
    if not t.is_cuda:
        return _fp_conv_out_plain(t, w, mode, out, H, W, nets)
    Bt, mid, _ = t.shape
    N = w.shape[0]
    nets = N if nets is None else nets
    if nets % N or Bt % nets:
        raise ValueError(f"{Bt} examples of {nets} nets on the kernels of {N} nets")
    c = out.reshape(Bt, -1).shape[1] // (H * W)
    _check_cuda(t=t, out=out)
    _check_cuda(_dtypes=(torch.bfloat16 if mode == "bf16" else torch.float32,), w=w)
    if mode == "bf16":
        check_conv3x3_tc("fp_conv_out", c, mid, H, W, C3_OUT_ROWS, t=t, w=w)
        wshape = (N, mid // C3_MID, 9 * c3_out_npad(c), C3_MID)
    else:
        if nets != N:  # the CUDA cores take one kernel a net
            w, N = w.repeat(nets // N, 1, 1, 1, 1), nets
        wshape = (N, c, mid, 3, 3)
    _shapes(t=(t, (Bt, mid, H * W)), w=(w, wshape),
            out=(out.reshape(Bt, -1), (Bt, c * H * W)))
    _run("imnf_fp_conv_out", _mode(mode), _ptr(w), _ptr(t), Bt, nets, N, c, mid, H, W,
         _ptr(out))
    fp_conv_out.launches += 1


TDOT_THREADS = 256  # fp_tdot's CTA (csrc/tdot.cu)
TDOT_CLUSTERS = (1, 2, 4, 8)  # its cluster sizes, the fewest first
TDOT_SMS = 132  # an H100's SMs: the grid fp_tdot's plan fills on the card


def tdot_plan(Bt, n, sms=TDOT_SMS):
    """(cluster, chunk) of ``fp_tdot``'s kernel (``csrc/tdot.cu``) at Bt
    examples of n elements: a thread-block cluster of ``cluster`` CTAs an
    example, CTA r summing elements [r * chunk, (r + 1) * chunk) as
    float4 vectors; the fewest CTAs of TDOT_CLUSTERS that give every SM 4
    of them (the most, 8, where none does), halved until they split n into
    whole vectors. Raises on n that is no multiple of 4."""
    if n <= 0 or n % 4:
        raise ValueError(f"fp_tdot reads float4 vectors: n % 4 == 0, not n {n}")
    cluster = next((c for c in TDOT_CLUSTERS if Bt * c >= 4 * sms), TDOT_CLUSTERS[-1])
    while n % (4 * cluster):
        cluster //= 2
    return cluster, n // cluster


def _fp_tdot_by(total, r, h, th, beta_net, out):
    """``fp_tdot``'s function with ``total`` summing each row of its (nb,
    M*HW) products; the products as the plain version rounds them."""
    N = beta_net.shape[0]
    nb = r.shape[0] // N
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        out[e] = total((r[e] * (dswish(h[e], beta_net[n]) * th[e])).reshape(nb, -1))


def _fp_tdot_plain(r, h, th, beta_net, out):
    _fp_tdot_by(lambda p: p.sum(1), r, h, th, beta_net, out)


def fp_tdot(r, h, th, beta_net, out):
    """out[e] = sum r (swish'(h; beta_net[n]) th) over channels and pixels
    of each example e of net n; r, h, th (N*nb, M, H*W); out (N*nb,). On the
    card each example runs on a thread-block cluster (:func:`tdot_plan`)."""
    if not r.is_cuda:
        return _fp_tdot_plain(r, h, th, beta_net, out)
    Bt = r.shape[0]
    N = beta_net.shape[0]
    _check_cuda(r=r, h=h, th=th, beta_net=beta_net, out=out)
    _check_aligned(r=r, h=h, th=th)
    _shapes(h=(h, r.shape), th=(th, r.shape), out=(out, (Bt,)))
    if Bt % N:
        raise ValueError(f"{Bt} examples do not split over {N} nets")
    n = r[0].numel()
    cluster, chunk = tdot_plan(Bt, n, _sms(r.device))
    _run("imnf_fp_tdot", _ptr(r), _ptr(h), _ptr(th), _ptr(beta_net), Bt, N, n, cluster,
         chunk, _ptr(out))
    fp_tdot.launches += 1


def _fp_second_plain(r, q, h, th, beta_net, rh, p, dsum, dbsum):
    N = beta_net.shape[0]
    nb, M = r.shape[0] // N, r.shape[1]
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        b = beta_net[n]
        ds = dswish(h[e], b)
        pv = d2swish(h[e], b) * th[e] * r[e]
        bv = ddswish_dbeta(h[e], b) * th[e] * r[e]
        if q is not None:
            pv = ds * q[e] + pv
            bv = dswish_dbeta(h[e], b) * q[e] + bv
        if rh is not None:
            rh[e] = ds * r[e]
        if p is not None:
            p[e] = pv
        chan = lambda v: v.transpose(0, 1).reshape(M, -1).sum(1)
        if dsum is not None:
            dsum[n] = chan(pv)
        dbsum[n] = chan(bv)


def fp_second(r, q, h, th, beta_net, rh, p, dsum, dbsum):
    """The second-order step of one layer of net n (slope beta_net[n]):
    ``rh = swish'(h) r``, ``p = [swish'(h) q] + swish''(h) th r``,
    ``dsum[n, m] = sum p`` and ``dbsum[n, m] = sum [dswish/dbeta(h) q] +
    d swish'/dbeta(h) th r`` over the examples and pixels of channel m. r,
    q, h, th, rh, p (N*nb, M, H*W); dsum, dbsum (N, M); q, rh, p, dsum
    optional."""
    if not r.is_cuda:
        return _fp_second_plain(r, q, h, th, beta_net, rh, p, dsum, dbsum)
    Bt, M, HW = r.shape
    N = beta_net.shape[0]
    if Bt % N:
        raise ValueError(f"{Bt} examples do not split over {N} nets")
    _check_cuda(r=r, q=q, h=h, th=th, beta_net=beta_net, rh=rh, p=p, dsum=dsum,
                dbsum=dbsum)
    _shapes(q=(q, r.shape), h=(h, r.shape), th=(th, r.shape), rh=(rh, r.shape),
            p=(p, r.shape), dsum=(dsum, (N, M)), dbsum=(dbsum, (N, M)))
    _run("imnf_fp_second", _ptr(r), _ptr(q), _ptr(h), _ptr(th), _ptr(beta_net),
         Bt, N, M, HW, _ptr(rh), _ptr(p), _ptr(dsum), _ptr(dbsum))
    fp_second.launches += 1


KERNELS = {"fp_conv_in": fp_conv_in, "fp_conv_mid": fp_conv_mid,
           "fp_conv_out": fp_conv_out, "fp_tdot": fp_tdot,
           "fp_second": fp_second}
for _fn in KERNELS.values():
    _fn.launches = 0
# the final pair's kernels with the re-attachment's weight gradients
_OPS = {**KERNELS, "rv_wgrad": ig.rv_wgrad, "rv_wgrad_reduce": ig.rv_wgrad_reduce}
_PLAIN = {"fp_conv_in": _fp_conv_in_plain, "fp_conv_mid": _fp_conv_mid_plain,
          "fp_conv_out": _fp_conv_out_plain, "fp_tdot": _fp_tdot_plain,
          "fp_second": _fp_second_plain, "rv_wgrad": ig._PLAIN["rv_wgrad"],
          "rv_wgrad_reduce": ig._PLAIN["rv_wgrad_reduce"]}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# the final pair

def _weights(datas, mode, dt):
    """Both nets' kernels prepared for mode (bf16-rounded in mode bf16),
    stacked per net, with their transposes, biases and slopes. Every kernel
    is cast once here to bfloat16 in mode bf16, exactly (the tensor cores'
    operand): w1 and w3t, which fp_conv_in reads, w2 and w2t (both nets'
    W2^T twice: the backward's rh2 and p_h2 in one launch), which
    fp_conv_mid reads, and w1t, the kernel of fp_conv_out, into the mid ->
    c kernel's tile layout (:func:`~.fused_chain.tile_w1t`)."""
    prep = lambda w: prep_weight(w.detach().to(dt), mode)[0]
    st = lambda ws: torch.stack(ws).contiguous()
    tc = lambda w: (w.to(torch.bfloat16) if mode == "bf16" else w).contiguous()
    tr = [transpose_weights(*(d[k].detach().to(dt) for k in ("w1", "w2", "w3")))
          for d in datas]
    wt = {k: st([prep(d[k]) for d in datas]) for k in ("w1", "w2")}
    wt["w3t"], w2t, wt["w1t"] = (st([prep(t[i]) for t in tr]) for i in range(3))
    wt["w2"], wt["w2t"] = tc(wt["w2"]), tc(torch.cat([w2t] * 2))
    wt["w1"], wt["w3t"] = tc(wt["w1"]), tc(wt["w3t"])
    if mode == "bf16":
        wt["w1t"] = tile_w1t(wt["w1t"])
    for k in ("b1", "b2"):
        wt[k] = st([d[k].detach().to(dt) for d in datas])
    wt["betas"] = st([d["betas"].detach().to(dt) for d in datas])  # (N, 3)
    wt["beta"] = [wt["betas"][:, i].contiguous() for i in range(3)]
    return wt


def _tangents(ops, mode, wt, Hs, E, preact):
    """h1, th1, h2, th2 of both nets at inputs Hs with tangents E."""
    Bt, c, H, W = Hs.shape
    mid = wt["w2"].shape[1]
    new = lambda: torch.empty(Bt, mid, H * W, device=Hs.device, dtype=Hs.dtype)
    H1, TH1, H2, TH2 = new(), new(), new(), new()
    b0, b1 = wt["beta"][:2]
    ops["fp_conv_in"](Hs, None, wt["w1"], wt["b1"], b0, "swish" if preact else "id",
                      mode, H1)
    ops["fp_conv_in"](E, Hs, wt["w1"], None, b0, "dswish" if preact else "id",
                      mode, TH1)
    ops["fp_conv_mid"](H1, None, wt["w2"], wt["b2"], b1, "swish", mode, H2, H, W)
    ops["fp_conv_mid"](TH1, H1, wt["w2"], None, b1, "dswish", mode, TH2, H, W)
    return H1, TH1, H2, TH2


def _primal(ops, mode, wt, Hs, E, ACC, preact):
    Bt, c, H, W = Hs.shape
    _, _, H2, TH2 = _tangents(ops, mode, wt, Hs, E, preact)
    R2 = torch.empty_like(H2)
    ops["fp_conv_in"](ACC, None, wt["w3t"], None, None, "id", mode, R2)
    T = torch.empty(Bt, device=Hs.device, dtype=Hs.dtype)
    ops["fp_tdot"](R2, H2, TH2, wt["beta"][2], T)
    return T


def _backward(ops, mode, wt, Hs, E, ACCW, preact, datas):
    """d_h and each net's gradient dict, with ACCW = acc * cotangent."""
    Bt, c, H, W = Hs.shape
    HW, dev, dt = H * W, Hs.device, Hs.dtype
    N = len(datas)
    B, mid = Bt // N, wt["w2"].shape[1]
    new = lambda *s: torch.empty(*s, device=dev, dtype=dt)
    b0, b1, b2 = wt["beta"]
    H1, TH1, H2, TH2 = _tangents(ops, mode, wt, Hs, E, preact)
    R2 = new(Bt, mid, HW)
    ops["fp_conv_in"](ACCW, None, wt["w3t"], None, None, "id", mode, R2)
    # rh2 = swish'(h2) r2, p_h2 = swish''(h2) th2 r2; db2, dbeta2
    RP2, db2, dbt2 = new(2, Bt, mid, HW), new(N, mid), new(N, mid)
    ops["fp_second"](R2, None, H2, TH2, b2, RP2[0], RP2[1], db2, dbt2)
    # ra1 = W2^T rh2, p_a1 = W2^T p_h2: one launch, the nets' W2^T twice
    RA = new(2, Bt, mid, HW)
    ops["fp_conv_mid"](RP2.view(2 * Bt, mid, HW), None, wt["w2t"], None, None, "id",
                       mode, RA.view(2 * Bt, mid, HW), H, W)
    # rh1 = swish'(h1) ra1, p_h1 = swish'(h1) p_a1 + swish''(h1) th1 ra1
    RP1, db1, dbt1 = new(2, Bt, mid, HW), new(N, mid), new(N, mid)
    ops["fp_second"](RA[0], RA[1], H1, TH1, b1, RP1[0], RP1[1], db1, dbt1)
    dbt0 = torch.zeros(N, c, device=dev, dtype=dt)
    if preact:
        # ra0 = C1^T rh1, p_a0 = C1^T p_h1 (one launch: four "nets" on the
        # two nets' kernels); d_h = swish'(h) p_a0 + swish''(h) e ra0
        A0 = new(2, Bt, c * HW)
        ops["fp_conv_out"](RP1.view(2 * Bt, mid, HW), wt["w1t"], mode, A0.view(2 * Bt, -1), H,
                           W, nets=2 * N)
        D_H = new(Bt, c, HW)
        ops["fp_second"](A0[0].view(Bt, c, HW), A0[1].view(Bt, c, HW), Hs.view(Bt, c, HW),
                         E.view(Bt, c, HW), b0, None, D_H, None, dbt0)
    else:
        D_H = new(Bt, c * HW)
        ops["fp_conv_out"](RP1[1], wt["w1t"], mode, D_H, H, W)

    def wgrad(name, M, Nc, products):
        """The sum over products (a, b, bh, beta, bin, shift) of their
        weight gradients, into the shape of the net's tensor name."""
        S, _ = wgrad_splits(M, Nc, B, HW)
        part = new(len(products) * S, M, Nc)
        for j, (a, b, bh, beta, bin_, shift) in enumerate(products):
            ops["rv_wgrad"](a, None, None, b, bh, beta, bin_, shift, mode,
                            part[j * S:(j + 1) * S], H, W)
        out = new(*datas[0][name].shape)
        ops["rv_wgrad_reduce"](part, 1.0, out)
        return out

    grads = []
    for n in range(N):
        e = slice(n * B, (n + 1) * B)
        bt = wt["betas"][n]  # the net's slopes on the device (3,)
        g = {"w3": wgrad("w3", c, mid * 9, [
            (ACCW[e], TH2[e], H2[e], bt[2], "dswish", True)])}
        g["w2"] = wgrad("w2", mid, mid, [
            (RP2[0][e], TH1[e], H1[e], bt[1], "dswish", False),
            (RP2[1][e], H1[e], None, bt[1], "swish", False)])
        g["w1"] = wgrad("w1", mid, c * 9, [
            (RP1[0][e], E[e], Hs[e] if preact else None, bt[0] if preact else None,
             "dswish" if preact else "id", True),
            (RP1[1][e], Hs[e], None, bt[0] if preact else None,
             "swish" if preact else "id", True)])
        g["b1"], g["b2"] = db1[n], db2[n]
        g["b3"] = torch.zeros_like(datas[n]["b3"])
        g["betas"] = torch.stack([dbt0[n].sum(), dbt1[n].sum(), dbt2[n].sum()])
        grads.append(g)
    return D_H.view(Bt, c, H, W), grads


class _FinalPair(torch.autograd.Function):
    """(T_x, T_z) with the hand-derived backward. Inputs: ops, mode, preact,
    x, z, eps_x, eps_z, acc_x, acc_z, then both nets' DATA_KEYS tensors."""

    @staticmethod
    def forward(ctx, ops, mode, preact, x, z, eps_x, eps_z, acc_x, acc_z, *tensors):
        k = len(DATA_KEYS)
        datas = [dict(zip(DATA_KEYS, tensors[:k])), dict(zip(DATA_KEYS, tensors[k:]))]
        dt = torch.promote_types(x.dtype, torch.float32)
        wt = _weights(datas, mode, dt)
        cat = lambda a, b: torch.cat([a.detach(), b.detach()]).to(dt).contiguous()
        T = _primal(ops, mode, wt, cat(x, z), cat(eps_x, eps_z), cat(acc_x, acc_z),
                    preact)
        ctx.ops, ctx.mode, ctx.preact = ops, mode, preact
        ctx.save_for_backward(x, z, eps_x, eps_z, acc_x, acc_z, *tensors)
        B = x.shape[0]
        return T[:B].to(x.dtype), T[B:].to(x.dtype)

    @staticmethod
    def backward(ctx, g_x, g_z):
        x, z, eps_x, eps_z, acc_x, acc_z, *tensors = ctx.saved_tensors
        k = len(DATA_KEYS)
        datas = [dict(zip(DATA_KEYS, tensors[:k])), dict(zip(DATA_KEYS, tensors[k:]))]
        dt = torch.promote_types(x.dtype, torch.float32)
        wt = _weights(datas, ctx.mode, dt)
        B = x.shape[0]
        fold = lambda acc, g: acc.detach().to(dt) * g.to(dt)[:, None, None, None]
        cat = lambda a, b: torch.cat([a.detach(), b.detach()]).to(dt).contiguous()
        ACCW = torch.cat([fold(acc_x, g_x), fold(acc_z, g_z)]).contiguous()
        d_h, (gx, gz) = _backward(ctx.ops, ctx.mode, wt, cat(x, z), cat(eps_x, eps_z),
                                  ACCW, ctx.preact, datas)
        cast = lambda g, like: g.to(like.dtype)
        return (None, None, None, cast(d_h[:B], x), cast(d_h[B:], z), None, None,
                None, None, *(cast(gx[n], t) for n, t in zip(DATA_KEYS, tensors[:k])),
                *(cast(gz[n], t) for n, t in zip(DATA_KEYS, tensors[k:])))


def _final_pair(ops, data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, mode):
    _mode(mode)
    preact = bool(data_x["preact"])
    if bool(data_z["preact"]) != preact:
        raise ValueError("the final pair takes two nets that share preact")
    return _FinalPair.apply(ops, mode, preact, x, z, eps_x, eps_z, acc_x, acc_z,
                            *(data_x[k] for k in DATA_KEYS),
                            *(data_z[k] for k in DATA_KEYS))


def fused_final_pair(data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, *, mode="bf16"):
    """Both nets' estimator-final terms ``(T_x, T_z)``, ``T = <acc, J_g(h)
    eps>`` (= ``<J^T acc, eps>``) at h = x for net x and h = z for net z,
    each (B,). ``data_*``: ``conv_forward_data`` dicts (with gradient from
    the raw parameters); x, z, eps, acc (B, c, H, W) float32. Gradients flow
    to the data tensors and to x and z. mode 'bf16' | 'f32'. CUDA tensors
    run the kernels, CPU tensors their plain versions."""
    return _final_pair(_OPS, data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, mode)


def fused_final_pair_plain(data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, *,
                           mode="bf16"):
    """:func:`fused_final_pair` with the plain versions forced."""
    return _final_pair(_PLAIN, data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, mode)
