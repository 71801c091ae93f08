"""The merged implicit-block forward: the forward solve, the linearisation of
both nets and both nets' stop-gradient Neumann chains, with its CUDA kernels.

Port of ``ops/fused_solve.py::fused_block_forward`` of the JAX package (TPU
kernel at ``fused_solve.py:1814``; ``_block_fwd_kernel`` :1706), which
training at ``--mem-eff False`` runs under ``IMNF_FUSED_BLOCK=1``. The TPU
kernel keeps one example's solve and its derivative factors in VMEM; on
Hopper it is four host-driven stages (``csrc/block_forward.cu``'s header
says what bounds its kernels on an H100 and what the design does about it):

A. the forward solve of ``ops.fused_solve`` with the phase-1 evaluation of
   net x at x through ``lin_conv3x3_in`` / ``lin_conv1x1_mid``, which also
   write the float32 swish derivatives s0 (under preact), s1 and s2 (in
   modes tf32 / tf32x both on the tensor cores: ``lin_conv3x3_in`` on
   ``csrc/conv3x3_in_tc.cuh``, ``lin_conv1x1_mid`` on
   ``csrc/mma_gemm.cuh`` as the solve's ``conv1x1_mid``);
B. net z once more at the best iterate ``z_hat``, in the phase-1 mode,
   through the same kernels (``fused_solve.py:1780``);
C. both nets' chains, ``acc = eps + sum_k c_k (J^T)^k eps``, on
   ``ops.fused_chain``'s ``nc_jt_*`` kernels with float32 s, in the chain
   dtype of the solver mode (float32 in mode f32, else bfloat16; not
   ``IMNF_BF16_EST``), the transposed kernels being the float32 effective
   weights rounded to it (``:1733-1734, 1837-1840``);
D. the protective-break patch (Banach root, accs reset to the probes) is
   the caller's (``layers.implicit_block``), as it is XLA's in JAX.

Net x is linearised at x, net z at ``z_hat`` (not at the re-attached z of
the split path, ``:1722-1727``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; a CUDA tensor never falls back. Each
wrapper counts its launches in ``<wrapper>.launches``.
:func:`fused_block_forward_plain` forces the plain versions on any device.
"""
from __future__ import annotations

import ctypes

import torch

from . import fused_chain as fc
from . import fused_solve as fs
from . import line_search as lsm
from .fused_solve import MODES, _check_cuda, _launch, _mconv, _ptr, _widened, dswish, swish
from .implicit_grad import _shapes

__all__ = ["fused_block_forward", "fused_block_forward_plain", "lin_conv3x3_in",
           "lin_conv1x1_mid", "KERNELS", "launch_counts", "reset_launch_counts"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "imnf_lin_conv3x3_in": [_I, _I, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P],
    "imnf_lin_conv1x1_mid": [_I, _P, _P, _P, _F, _P, _I, _I, _I, _I, _P, _P, _P],
}


def _lib():
    from . import cuda_build

    lib = cuda_build.load("block_forward")
    for fn, args in _ARGTYPES.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes, f.restype = args, ctypes.c_int
    return lib


def _run(fn, *args):
    _launch(fn, *args, lib=_lib())


# ---------------------------------------------------------------------------
# the linearisation variants of the solve's first two convs: every example
# live, slot s is example s; out, s1, s2 (B, mid, H*W), s0 (B, c*H*W), all
# float32

def _lin_conv3x3_in_by(product, inp, wp, b1, betas, preact, mode, out, s1, s0):
    """``lin_conv3x3_in``'s function with ``product(h, wp, mode)`` for its
    3x3 product (b1, swish and swish' after it, rounded as the kernels
    round them)."""
    B, c, H, W = inp.shape
    h = inp
    if preact:
        s0.copy_(dswish(inp, betas[0]).reshape(B, -1))
        h = swish(h, betas[0])
    h1 = product(h, wp, mode) + b1[None, :, None, None]
    out.copy_(swish(h1, betas[1]).reshape(out.shape))
    s1.copy_(dswish(h1, betas[1]).reshape(s1.shape))


def _lin_conv3x3_in_plain(inp, wp, b1, betas, preact, mode, out, s1, s0):
    _lin_conv3x3_in_by(lambda h, w, m: _mconv(h, _widened(w), m, 1), inp, wp, b1, betas,
                       preact, mode, out, s1, s0)


def lin_conv3x3_in(inp, wp, b1, betas, preact, mode, out, s1, s0):
    """out = swish(h1, beta1) and s1 = swish'(h1, beta1) with h1 =
    conv3x3([swish](inp)) + b1; under preact also s0 = swish'(inp, beta0).
    inp (B, c, H, W); wp = (w_hi, w_lo) of the (mid, c, 3, 3) kernel from
    :func:`~.fused_solve.prep_conv1x1_mid`: in the split modes, which run
    on the tensor cores (``csrc/conv3x3_in_tc.cuh``; ``tc_launches`` counts
    those launches), bfloat16 halves, with what
    :func:`~.fused_solve.check_conv3x3_tc` asks of the shapes (two im2col
    tiles within an SM's shared memory) and 16-byte aligned outputs;
    float32 in modes f32 / bf16 (the CUDA cores).
    betas (3,) host floats or a tensor."""
    if not inp.is_cuda:
        return _lin_conv3x3_in_plain(inp, wp, b1, betas, preact, mode, out, s1, s0)
    B, c, H, W = inp.shape
    mid = wp[0].shape[0]
    split = mode in fs.SPLIT_MODES
    _check_cuda(inp=inp, b1=b1, out=out, s1=s1, s0=s0 if preact else None)
    _check_cuda(_dtypes=(torch.bfloat16 if split else torch.float32,), w_hi=wp[0],
                w_lo=wp[1])
    _shapes(w=(wp[0], (mid, c, 3, 3)), out=(out, (B, mid, H * W)), s1=(s1, (B, mid, H * W)),
            s0=(s0 if preact else None, (B, c * H * W)))
    if split:
        if wp[1] is None:
            raise ValueError(f"lin_conv3x3_in in {mode} takes both halves of the split")
        fs.check_conv3x3_tc("lin_conv3x3_in", c, mid, H, W, fs.conv3x3_in_rows(W), panels=2,
                            out=out, s1=s1)
    b = [float(v) for v in betas]
    _run("imnf_lin_conv3x3_in", MODES[mode], int(preact), _ptr(wp[0]), _ptr(wp[1]),
         _ptr(b1), b[0], b[1], _ptr(inp), B, c, H, W, mid, _ptr(out), _ptr(s1),
         _ptr(s0) if preact else None)
    lin_conv3x3_in.launches += 1
    if split:
        lin_conv3x3_in.tc_launches += 1


def _lin_conv1x1_mid_plain(t1, wp, b2, beta2, mode, out, s2, H, W):
    B, mid, _ = t1.shape
    h2 = _mconv(t1.reshape(B, mid, H, W), _widened(wp), mode, 0) + b2[None, :, None, None]
    out.copy_(swish(h2, beta2).reshape(out.shape))
    s2.copy_(dswish(h2, beta2).reshape(s2.shape))


def lin_conv1x1_mid(t1, wp, b2, beta2, mode, out, s2, H, W):
    """out = swish(h2, beta2) and s2 = swish'(h2, beta2) with h2 = W2 t1 +
    b2; t1, out, s2 (B, mid, H*W). wp from
    :func:`~.fused_solve.prep_conv1x1_mid`: in the split modes, which run
    on the tensor cores (``tc_launches`` counts those launches), bfloat16
    halves, with what :func:`~.fused_solve.check_mid_product` asks of the
    shapes; float32 in modes f32 / bf16 (the CUDA cores)."""
    if not t1.is_cuda:
        return _lin_conv1x1_mid_plain(t1, wp, b2, beta2, mode, out, s2, H, W)
    B, mid, _ = t1.shape
    split = fs.check_mid_product("lin_conv1x1_mid", t1, wp, mode, b2=b2, out=out, s2=s2)
    _run("imnf_lin_conv1x1_mid", MODES[mode], _ptr(wp[0]), _ptr(wp[1]), _ptr(b2),
         float(beta2), _ptr(t1), B, mid, H, W, _ptr(out), _ptr(s2))
    lin_conv1x1_mid.launches += 1
    if split:
        lin_conv1x1_mid.tc_launches += 1


KERNELS = {"lin_conv3x3_in": lin_conv3x3_in, "lin_conv1x1_mid": lin_conv1x1_mid}
_PLAIN = {"lin_conv3x3_in": _lin_conv3x3_in_plain,
          "lin_conv1x1_mid": _lin_conv1x1_mid_plain}
for _fn in KERNELS.values():
    _fn.launches = 0
lin_conv3x3_in.tc_launches = 0  # their launches on the tensor cores (split modes)
lin_conv1x1_mid.tc_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    lin_conv3x3_in.tc_launches = lin_conv1x1_mid.tc_launches = 0


# ---------------------------------------------------------------------------
# the block forward

# the whole forward's kernels (the solve's with its line search's, this
# module's and the chain's), or their plain versions
_OPS = {**fs.KERNELS, **lsm.KERNELS, **KERNELS, **fc.KERNELS}
_PLAIN_OPS = {**fs._PLAIN, **lsm._PLAIN, **_PLAIN, **fc._PLAIN}


def _block_forward(ops, x, data_x, data_z, eps_x, eps_z, signed_coeffs, n_power,
                   **solve_kw):
    """Stages A-C on the kernels (or plain versions) of ``ops``."""
    res, lin = fs._solve(x, data_x, data_z, ops, linearise=True, **solve_kw)
    acc_x, acc_z = fc._chain(chains(data_x, data_z, eps_x, eps_z, lin, solve_kw["mode"]),
                             signed_coeffs, n_power, ops)
    return res, acc_x, acc_z


def chains(data_x, data_z, eps_x, eps_z, lin, mode):
    """Both nets' chain operands ``(eps, s0, s1, s2, w1, w2, w3)`` for
    ``ops.fused_chain`` from the solve's linearisation ``lin``: the probes
    and the float32 effective weights rounded to the chain dtype of the
    solver ``mode`` (``fused_solve.py:1837-1840``), the s factors float32."""
    cdtype = torch.float32 if mode == "f32" else torch.bfloat16

    def chain(eps, data, s):
        ws = (data[k].detach().float().to(cdtype) for k in ("w1", "w2", "w3"))
        return (eps.detach().to(cdtype), *s, *ws)

    return chain(eps_x, data_x, lin["x"]), chain(eps_z, data_z, lin["z"])


def fused_block_forward(x, data_x, data_z, eps_x, eps_z, signed_coeffs, n_power, *,
                        threshold, eps, stall_patience, stall_rtol, stall_guard=None,
                        newton_init=False, warm_start=False, mode="tf32",
                        tail_mode=None, tail_start=None, line_search=False):
    """Solve ``z : x + g_x(x) = z + g_z(z)`` per example and run both nets'
    Neumann chains; returns ``(FusedSolveResult, acc_x, acc_z)``, the accs
    float32 (B, c, H, W) as x.

    x, data_x, data_z and the solver arguments: as
    :func:`~.fused_solve.fused_broyden_solve`. eps_x / eps_z: (B, c, H, W)
    Rademacher probes; signed_coeffs: (cap,) roulette coefficients with the
    (-1)^k sign folded in; n_power: host int <= cap. CUDA tensors run the
    kernels, CPU tensors their plain versions."""
    return _block_forward(_OPS, x, data_x, data_z, eps_x, eps_z, signed_coeffs,
                          n_power, threshold=threshold, eps=eps,
                          stall_patience=stall_patience, stall_rtol=stall_rtol,
                          stall_guard=stall_guard, newton_init=newton_init,
                          warm_start=warm_start, mode=mode, tail_mode=tail_mode,
                          tail_start=tail_start, line_search=line_search)


def fused_block_forward_plain(x, data_x, data_z, eps_x, eps_z, signed_coeffs, n_power,
                              **kwargs):
    """:func:`fused_block_forward` with every kernel (the solve's too)
    replaced by its plain PyTorch version, on whatever device ``x`` lies."""
    kw = dict(stall_guard=None, newton_init=False, warm_start=False, mode="tf32",
              tail_mode=None, tail_start=None, line_search=False)
    kw.update(kwargs)
    return _block_forward(_PLAIN_OPS, x, data_x, data_z, eps_x, eps_z, signed_coeffs,
                          n_power, **kw)
