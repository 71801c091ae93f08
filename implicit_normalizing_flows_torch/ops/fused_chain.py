"""The stop-gradient Neumann accumulations of one or both nets with their
CUDA kernels.

Port of ``ops/fused_chain.py::fused_neumann_chain2`` of the JAX package (TPU
kernel at ``fused_chain.py:333``; ``_chain2_kernel`` :239, ``_make_apply_jt``
:182) and of its one-net twin ``fused_neumann_chain`` (TPU kernel at
``fused_chain.py:275``; ``_chain_kernel`` :216), which runs the same
kernels on one net: for each net ``acc = eps + sum_{k=1}^{n_power} c_k (J^T)^k eps`` with
``J^T = S0 C1^T S1 C2^T S2 C3^T`` at the linearisation point and the signed
roulette coefficients ``c_k`` (the ``(-1)^k`` folded in). The TPU kernel runs
one example's whole series per grid step with its derivative factors
resident in VMEM; on Hopper each term is three batched kernels of
``csrc/estimator.cu`` (that file's header says what bounds them on an H100
and what the design does about it), each launched once for both nets, whose
examples are stacked along the batch:

* ``nc_jt_in``       ``t2 = rnd(C3^T u * s2)`` (mode bf16: on the tensor
  cores, ``csrc/conv3x3_in_tc.cuh``, with the kernel ``w3t`` in bfloat16)
* ``nc_jt_mid``      ``t1 = rnd(C2^T t2 * s1)`` (mode bf16: on the tensor
  cores, ``csrc/mma_gemm.cuh``, with the kernel ``w2t`` in bfloat16)
* ``nc_jt_out_acc``  ``u = rnd(s0 * C1^T t1)``, ``acc += c_k * u`` (mode bf16:
  on the tensor cores, ``csrc/conv3x3_out_tc.cuh``, with the kernel ``w1t``
  cast once per chain call into that kernel's tile layout,
  :func:`tile_w1t`)

``rnd`` rounds to the chain dtype (the probe's: bfloat16 under
``IMNF_BF16_EST``, float32 otherwise) exactly where ``_make_apply_jt``
rounds (``fused_chain.py:199, 203, 211``); the products round their operands
to that dtype and sum in float32, the accumulation is float32 (``:264``).
Every example runs all ``n_power`` terms (a host int: no host read per
term); ``c_k`` is read from a device array.

Not ported: ``pack_reps`` / ``choose_reps`` (TPU lane tiling of small
images) and the im2col matrix layouts of ``conv3_transpose_mats`` and
friends: layout, not semantics. The kernels take the OIHW kernels of
:func:`~.implicit_grad.transpose_weights`.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; a CUDA tensor never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
:func:`fused_neumann_chain2_plain` and :func:`fused_neumann_chain_plain`
force the plain versions on any device.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_solve import (C3_MID, C3_OUT_ROWS, MODES, _check_cuda, _launch, _mconv, _ptr,
                          _wide, c3_out_npad, check_conv3x3_tc, conv3x3_in_rows, tile_w1t,
                          untile_w1t)
from .implicit_grad import _check_mid, _shapes, mid_weight_dtype, transpose_weights

__all__ = ["fused_neumann_chain2", "fused_neumann_chain2_plain",
           "fused_neumann_chain", "fused_neumann_chain_plain", "KERNELS",
           "launch_counts", "reset_launch_counts", "chain_mode", "chain_operands",
           "mid_weight_dtype", "tile_w1t", "untile_w1t", "c3_out_npad"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "imnf_nc_jt_in": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "imnf_nc_jt_mid": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "imnf_nc_jt_out_acc": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P],
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


def chain_mode(dtype):
    """The products' precision of a chain in ``dtype``: 'bf16' rounds them
    and the stage outputs to bfloat16, 'f32' is exact float32."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _rnd(v, mode):
    return v.to(torch.bfloat16).to(v.dtype) if mode == "bf16" else v


def _nets(w, n):
    """(nets, examples per net) of a launch on n stacked examples with the
    nets' weights stacked in w."""
    nets = w.shape[0]
    if n % nets:
        raise ValueError(f"{n} examples do not split over {nets} nets")
    return nets, n // nets


def _check(s, mode, **others):
    """Check a stage's operands (s its derivative factor, float32 or
    bfloat16); returns the kernel's s_bf16 flag."""
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"s: dtype {s.dtype} not taken")
    if mode not in ("f32", "bf16"):
        raise ValueError(f"chain mode {mode!r}: 'f32' | 'bf16'")
    _check_cuda(_dtypes=(s.dtype, torch.float32), s=s, **others)
    return int(s.dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# the three stages. u, acc: (N*nb, c, H, W) / (N*nb, c*H*W) float32; t1, t2:
# (N*nb, mid, H*W); s0/s1/s2 in the chain dtype; weights stacked per net:
# w3t (N, mid, c, 3, 3), w2t (N, mid, mid, 1, 1), w1t (N, c, mid, 3, 3);
# w3t and w2t in mode bf16 as bfloat16, w1t in mode bf16 in the tile layout
# (:func:`chain_operands`).

def _nc_jt_in_by(product, u, w3t, s2, mode, out):
    """``nc_jt_in``'s function with ``product(u, w, mode)`` for each net's
    3x3 product (w that net's kernel in u's dtype); the scale and the
    rounding after it, as the kernels take them."""
    N, nb = _nets(w3t, u.shape[0])
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        y = product(u[e], w3t[n].to(u.dtype), mode)
        out[e] = _rnd(y * s2[e].reshape(y.shape).to(y.dtype), mode).reshape(out[e].shape)


def _nc_jt_in_plain(u, w3t, s2, mode, out):
    _nc_jt_in_by(lambda x, w, m: _mconv(x, (w, None), m, 1), u, w3t, s2, mode, out)


def nc_jt_in(u, w3t, s2, mode, out):
    """out = rnd(C3^T u * s2) for every example of every net; w3t in
    :func:`mid_weight_dtype`. Mode bf16 runs on the tensor cores
    (``csrc/conv3x3_in_tc.cuh``): w3t bfloat16, and what
    :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with
    16-byte aligned s2 and out."""
    if not u.is_cuda:
        return _nc_jt_in_plain(u, w3t, s2, mode, out)
    Bt, c, H, W = u.shape
    N, _ = _nets(w3t, Bt)
    mid = w3t.shape[1]
    sbf16 = _check(s2, mode, u=u, out=out)
    _check_cuda(_dtypes=(mid_weight_dtype(mode),), w=w3t)
    if mode == "bf16":
        check_conv3x3_tc("nc_jt_in", c, mid, H, W, conv3x3_in_rows(W), s2=s2, out=out)
    _shapes(w=(w3t, (N, mid, c, 3, 3)), s2=(s2, (Bt, mid, H * W)),
            out=(out, (Bt, mid, H * W)))
    _run("imnf_nc_jt_in", MODES[mode], _ptr(w3t), _ptr(u), _ptr(s2), sbf16, Bt, N,
         c, H, W, mid, _ptr(out))
    nc_jt_in.launches += 1


def _nc_jt_mid_plain(t, w2t, s1, mode, out, H, W):
    N, nb = _nets(w2t, t.shape[0])
    mid = t.shape[1]
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        y = _mconv(t[e].reshape(nb, mid, H, W), (w2t[n].to(t.dtype), None), mode, 0)
        out[e] = _rnd(y * s1[e].reshape(y.shape).to(y.dtype), mode).reshape(nb, mid, H * W)


def nc_jt_mid(t, w2t, s1, mode, out, H, W):
    """out = rnd(C2^T t * s1); t, s1, out (N*nb, mid, H*W); w2t bfloat16
    in mode bf16 on the card (:func:`mid_weight_dtype`)."""
    if not t.is_cuda:
        return _nc_jt_mid_plain(t, w2t, s1, mode, out, H, W)
    Bt, mid, _ = t.shape
    N, _ = _nets(w2t, Bt)
    sbf16 = _check(s1, mode, t=t, out=out)
    _check_mid(w2t, mode, mid, H * W, t=t, s1=s1, out=out)
    _shapes(t=(t, (Bt, mid, H * W)), w=(w2t, (N, mid, mid, 1, 1)),
            s1=(s1, t.shape), out=(out, t.shape))
    _run("imnf_nc_jt_mid", MODES[mode], _ptr(w2t), _ptr(t), _ptr(s1), sbf16, Bt, N,
         mid, H, W, _ptr(out))
    nc_jt_mid.launches += 1


def _nc_jt_out_acc_by(product, t, w1t, s0, mode, coeffs, k, u_out, acc, H, W):
    """``nc_jt_out_acc``'s function with ``product(t, wp, mode)`` for each
    net's 3x3 product (wp that net's OIHW kernel, unpacked from the tile
    layout where it comes so); the scale, the rounding and the
    accumulation after it, as the kernels take them."""
    mid = t.shape[1]
    w1t = untile_w1t(w1t, u_out.shape[1], mid)
    N, nb = _nets(w1t, t.shape[0])
    for n in range(N):
        e = slice(n * nb, (n + 1) * nb)
        y = product(t[e].reshape(nb, mid, H, W), (w1t[n].to(t.dtype), None), mode).reshape(nb, -1)
        v = _rnd(y * s0[e].to(y.dtype), mode)
        u_out[e] = v.reshape(u_out[e].shape)
        acc[e] += coeffs[k] * v


def _nc_jt_out_acc_plain(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W):
    _nc_jt_out_acc_by(lambda x, wp, m: _mconv(x, wp, m, 1), t, w1t, s0, mode, coeffs, k, u_out,
                      acc, H, W)


def nc_jt_out_acc(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W):
    """u_out = rnd(s0 * C1^T t); acc += coeffs[k] * u_out. t (N*nb, mid,
    H*W); s0, acc (N*nb, c*H*W); u_out (N*nb, c, H, W); coeffs a device
    vector of signed coefficients. Mode bf16 runs on the tensor cores
    (``csrc/conv3x3_out_tc.cuh``): w1t in :func:`tile_w1t`'s layout, and
    what :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes, with
    16-byte aligned t and w1t; mode f32 takes w1t (N, c, mid, 3, 3)
    float32."""
    if not t.is_cuda:
        return _nc_jt_out_acc_plain(t, w1t, s0, mode, coeffs, k, u_out, acc, H, W)
    Bt, mid, _ = t.shape
    c = u_out.shape[1]
    N, _ = _nets(w1t, Bt)
    if not 0 <= k < coeffs.shape[0]:
        raise ValueError(f"term {k} outside the {coeffs.shape[0]} coefficients")
    sbf16 = _check(s0, mode, t=t, coeffs=coeffs, u_out=u_out, acc=acc)
    _check_cuda(_dtypes=(torch.bfloat16 if mode == "bf16" else torch.float32,), w=w1t)
    if mode == "bf16":
        check_conv3x3_tc("nc_jt_out_acc", c, mid, H, W, C3_OUT_ROWS, t=t, w=w1t)
        wshape = (N, mid // C3_MID, 9 * c3_out_npad(c), C3_MID)
    else:
        wshape = (N, c, mid, 3, 3)
    D = (Bt, c * H * W)
    _shapes(t=(t, (Bt, mid, H * W)), w=(w1t, wshape), s0=(s0, D),
            u_out=(u_out.reshape(Bt, -1), D), acc=(acc, D))
    _run("imnf_nc_jt_out_acc", MODES[mode], _ptr(w1t), _ptr(t), _ptr(s0), sbf16,
         _ptr(coeffs), int(k), Bt, N, c, mid, H, W, _ptr(u_out), _ptr(acc))
    nc_jt_out_acc.launches += 1


KERNELS = {"nc_jt_in": nc_jt_in, "nc_jt_mid": nc_jt_mid,
           "nc_jt_out_acc": nc_jt_out_acc}
_PLAIN = {"nc_jt_in": _nc_jt_in_plain, "nc_jt_mid": _nc_jt_mid_plain,
          "nc_jt_out_acc": _nc_jt_out_acc_plain}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# the chain

def chain_operands(chains, signed_coeffs):
    """The stage kernels' operands for the nets' ``chains`` (eps, s0, s1,
    s2, w1, w2, w3): the probes U and the accumulation ACC (a copy of the
    probes) in float32, the derivative factors S0/S1/S2 as stored, the
    transposed kernels W3T/W2T/W1T stacked per net (in mode bf16, the
    tensor-core products', cast once here, exactly, since they hold
    bfloat16 values: W3T and W2T to :func:`mid_weight_dtype`, W1T into the
    mid -> c kernel's tile layout, :func:`tile_w1t`), the coefficients on
    the device, and the mode."""
    eps0 = chains[0][0]
    B, c, H, W = eps0.shape
    HW, dev, N = H * W, eps0.device, len(chains)
    wide = _wide(eps0.dtype)
    # the derivative factors as stored (bf16 in mode bf16), the probes and
    # the kernels widened: bf16 values in a wider type are exact
    sdt = lambda s: s if s.dtype == torch.bfloat16 else s.to(wide)
    cat = lambda i, shape: torch.cat([sdt(ch[i].detach()).reshape(B, *shape)
                                      for ch in chains]).contiguous()
    wts = [transpose_weights(*(w.detach().to(wide) for w in ch[4:7])) for ch in chains]
    U = torch.cat([ch[0].detach().to(wide) for ch in chains]).contiguous()
    mode = chain_mode(eps0.dtype)
    tc = lambda i: torch.stack([w[i] for w in wts]).to(
        torch.bfloat16 if mode == "bf16" else wide).contiguous()
    w1t = torch.stack([w[2] for w in wts]).contiguous()
    return dict(
        U=U, ACC=U.reshape(N * B, c * HW).clone(), S0=cat(1, (c * HW,)),
        S1=cat(2, (-1, HW)), S2=cat(3, (-1, HW)), W3T=tc(0), W2T=tc(1),
        W1T=w1t if mode != "bf16" else tile_w1t(w1t),
        coeffs=signed_coeffs.detach().to(device=dev, dtype=wide).contiguous(),
        mode=mode)


def _chain(chains, signed_coeffs, n_power, ops):
    B, c, H, W = chains[0][0].shape
    n_power = int(n_power)
    if n_power > signed_coeffs.shape[0]:
        raise ValueError(f"n_power {n_power} > {signed_coeffs.shape[0]} coefficients")
    op = chain_operands(chains, signed_coeffs)
    U, ACC, mode = op["U"], op["ACC"], op["mode"]
    T2 = U.new_empty(U.shape[0], op["S1"].shape[1], H * W)
    T1 = torch.empty_like(T2)
    for k in range(n_power):
        ops["nc_jt_in"](U, op["W3T"], op["S2"], mode, T2)
        ops["nc_jt_mid"](T2, op["W2T"], op["S1"], mode, T1, H, W)
        ops["nc_jt_out_acc"](T1, op["W1T"], op["S0"], mode, op["coeffs"], k, U, ACC, H, W)
    return tuple(ACC[n * B:(n + 1) * B].reshape(B, c, H, W) for n in range(len(chains)))


def fused_neumann_chain2(chain_x, chain_z, signed_coeffs, n_power):
    """Both nets' ``acc = eps + sum_{k=1}^{n_power} signed_coeffs[k-1]
    (J^T)^k eps``, returned as ``(acc_x, acc_z)``, float32 (B, c, H, W).

    ``chain_*`` = (eps, s0, s1, s2, w1, w2, w3): the probe (B, c, H, W), whose
    dtype is the chain's (bfloat16 or float32), and ``LipschitzNet.
    conv_chain_data`` at the linearisation point in that dtype.
    ``signed_coeffs`` (cap,) carries the (-1)^k signs; ``n_power`` is a host
    int <= cap. CUDA tensors run the kernels, CPU tensors their plain
    versions."""
    return _chain((chain_x, chain_z), signed_coeffs, n_power, KERNELS)


def fused_neumann_chain2_plain(chain_x, chain_z, signed_coeffs, n_power):
    """:func:`fused_neumann_chain2` with the plain versions forced."""
    return _chain((chain_x, chain_z), signed_coeffs, n_power, _PLAIN)


def fused_neumann_chain(chain, signed_coeffs, n_power):
    """One net's ``acc = eps + sum_{k=1}^{n_power} signed_coeffs[k-1]
    (J^T)^k eps``, float32 (B, c, H, W); ``chain`` = (eps, s0, s1, s2, w1,
    w2, w3) as in :func:`fused_neumann_chain2`. The same kernels, launched
    on one net."""
    return _chain((chain,), signed_coeffs, n_power, KERNELS)[0]


def fused_neumann_chain_plain(chain, signed_coeffs, n_power):
    """:func:`fused_neumann_chain` with the plain versions forced."""
    return _chain((chain,), signed_coeffs, n_power, _PLAIN)[0]
