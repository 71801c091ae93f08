"""The final pair's 1x1 product in the tensor cores' sum order, on the CPU.

In mode bf16 ``fp_conv_mid``'s kernel (``csrc/mma_gemm.cuh``) sums each K
tile of 64 channels into a fresh float32 partial and adds the partials in
order; ``ops/sum_order.py::fp_conv_mid_tiled`` is its plain version summed
that way. ``chip_smoke.py`` phase 9 holds the final pair on the kernels
against the plain pair with that product summed exactly
(``fp_conv_mid_exact``: float64 sums, one rounding) at ``FINAL_TOL`` 1e-5.

* The repaired phase-9 comparison at the port's test size (c 3 and 12,
  8x8, idim 16, both nets, batch 2, the inputs of
  ``test_torch_final_pair.py``): the plain pair with ``fp_conv_mid_tiled``
  against the plain pair with ``fp_conv_mid_exact``, by rel_norm on T, d_h
  and every gradient, at 1e-5; and the control, the plain pair in mode f32,
  which must read above 1e-5 against the same reference on every output a
  product reaches: the reference can fail a path that skips the rounding.
* ``fp_conv_mid_tiled`` at the flagship's mid 512 (8 K tiles), 8x8, one
  example per net, with act id / swish / dswish on 2 and 4 nets, against
  the JAX package's bf16 product (``_make_dot("bf16")``,
  ``implicit_normalizing_flows_tpu/ops/fused_solve.py``, with its kernels'
  swish family), at the tolerance of ``test_torch_tc_gemm.py`` (rel_norm
  2e-5), with the control (mode f32) above it.
"""
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.fused_solve import _dswish, _swish
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm
from test_torch_final_pair import NAMES, _inputs
from test_torch_tc_gemm import _jax_bf16_dot, net_weights

FINAL_TOL = 1e-5   # chip_smoke.py's FINAL_TOL["bf16"]
PRODUCT_TOL = 2e-5  # test_torch_tc_gemm.py's FINAL_TOL
MID, H, W = 512, 8, 8


def _pair(dx, dz, arrays, cot, mode, ops):
    """T, d_h and both nets' gradients of the final pair on ``ops``, as
    chip_smoke.py's phase 9 runs it (the cotangent folded into acc)."""
    t = lambda d: {k: (torch.from_numpy(np.array(a)) if k != "preact" else a)
                   for k, a in d.items()}
    datas = [t(dx), t(dz)]
    x, z, ex, ez, ax, az = (torch.from_numpy(a) for a in arrays)
    c = torch.from_numpy(cot)
    cat = lambda a, b: torch.cat([a, b]).contiguous()
    Hs, E, ACC = cat(x, z), cat(ex, ez), cat(ax, az)
    ACCW = cat(ax * c[0][:, None, None, None], az * c[1][:, None, None, None])
    wt = ff._weights(datas, mode, torch.float32)
    preact = bool(dx["preact"])
    T = ff._primal(ops, mode, wt, Hs, E, ACC, preact)
    d_h, g = ff._backward(ops, mode, wt, Hs, E, ACCW, preact, datas)
    return [("T", T), ("d_h", d_h)] + [
        (f"{n}.{k}", g[i][k]) for i, n in enumerate("xz") for k in NAMES]


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_tiled_pair_within_final_tol_of_exact(c, preact):
    dx, dz, arrays, cot = _inputs(c, preact)
    ref = _pair(dx, dz, arrays, cot, "bf16", dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_exact))
    got = _pair(dx, dz, arrays, cot, "bf16", dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_tiled))
    worst = max((rel_norm(a.numpy(), b.numpy()), n) for (n, a), (_, b) in zip(got, ref))
    assert worst[0] <= FINAL_TOL, worst


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_f32_control_fails_the_exact_reference(c, preact):
    dx, dz, arrays, cot = _inputs(c, preact)
    ref = _pair(dx, dz, arrays, cot, "bf16", dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_exact))
    ctrl = _pair(dx, dz, arrays, cot, "f32", ff._PLAIN)
    # b3's gradient is exactly zero on both sides: no product reaches it
    least = min((rel_norm(a.numpy(), b.numpy()), n) for (n, a), (_, b) in zip(ctrl, ref)
                if not n.endswith(".b3"))
    assert least[0] > FINAL_TOL, least


@pytest.mark.parametrize("nets", [2, 4])
@pytest.mark.parametrize("act", ["id", "swish", "dswish"])
def test_fp_conv_mid_tiled_matches_jax(act, nets):
    rng = np.random.RandomState(20 * nets + len(act))
    w2 = np.stack([net_weights(rng)[1] for _ in range(nets)])
    inp = rng.standard_normal((nets, MID, H * W)).astype(np.float32)
    inh = rng.standard_normal((nets, MID, H * W)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((nets, MID))).astype(np.float32)
    beta = (1.0 + 0.2 * rng.standard_normal(nets)).astype(np.float32)
    with_bias = act == "swish"  # h2 = W2 swish(h1) + b2; th2 and the W2^T products have none
    ref = []
    for n in range(nets):
        x, h, b = inp[n], inh[n], np.float32(beta[n])
        a = _swish(x, b) if act == "swish" else x * _dswish(h, b) if act == "dswish" else x
        y = _jax_bf16_dot(w2[n, :, :, 0, 0], np.asarray(a))
        ref.append(y + bias[n][:, None] if with_bias else y)
    ref = np.stack(ref)

    def run(fn, mode, w):
        out = torch.zeros(nets, MID, H * W)
        fn(torch.from_numpy(inp), torch.from_numpy(inh), w,
           torch.from_numpy(bias) if with_bias else None, torch.from_numpy(beta), act, mode,
           out, H, W)
        return out.numpy()

    # the kernel's operand: W2 cast once to bfloat16 (fused_final._weights)
    err = rel_norm(run(so.fp_conv_mid_tiled, "bf16", torch.from_numpy(w2).to(torch.bfloat16)),
                   ref)
    ctrl = rel_norm(run(ff._fp_conv_mid_plain, "f32", torch.from_numpy(w2)), ref)
    assert err <= PRODUCT_TOL < ctrl, (err, ctrl)
