"""The Python side of the 1x1 products of mode bf16 on the CPU: the
Neumann chain's ``nc_jt_mid`` and the final pair's ``fp_conv_mid``, whose
kernels run on the tensor cores (``csrc/mma_gemm.cuh``; the kernel's sum
order for ``fp_conv_mid`` is ``test_torch_tc_order.py``'s).

* The once-per-step weight preparation: in mode bf16 the kernel that
  ``nc_jt_mid`` reads (``chain_operands``' W2T) is bfloat16, contiguous, in
  the (nets, mid, mid, 1, 1) layout the kernel indexes (net, row m, column
  k), and equal to the float32 bfloat16-valued kernel exactly; in mode f32
  it stays float32.
* The plain versions, which the kernels are held against on the card, at
  the shapes of the tensor-core kernel's smallest grid (mid 512, 8x8, one
  example per net), against the JAX package's bf16 product (``_make_dot("bf16")``,
  ``implicit_normalizing_flows_tpu/ops/fused_solve.py``, and the elementwise
  math of its kernels): ``rnd(C2^T t * s1)`` (``ops/fused_chain.py``
  ``_make_apply_jt``) with s bfloat16 or float32, and ``W2 act(inp) [+ b2]``
  (``_final_T_in_kernel``) with act id / swish / dswish on 2 and 4 nets.
  Tolerances are the suite's for these products: the chain's rounded stage
  by ``rel_norm`` at 1e-4 (``test_torch_neumann_chain.py``: an output one
  float32 ulp apart rounds to another bfloat16 at a few ties), the final
  pair's unrounded product at 2e-5 (``test_torch_final_pair.py``); each
  with the control, the plain version in mode f32 on the same inputs, which
  must read above it (measured here: ``nc_jt_mid`` 7.9e-6 or less,
  ``fp_conv_mid`` 1.7e-7 or less, every control 1.6e-3 or more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.fused_solve import _dswish, _make_dot, _swish
from implicit_normalizing_flows_torch.ops import fused_chain as fc
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import implicit_grad as ig

from test_torch_backward_solve import rel_norm

MID, H, W = 512, 8, 8
HW = H * W
CHAIN_TOL, FINAL_TOL = 1e-4, 2e-5


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def net_weights(rng, c=3):
    """One net's (w1, w2, w3) at the flagship's widths, bfloat16 values."""
    return (bf16(rng.standard_normal((MID, c, 3, 3)) * 0.1),
            bf16(rng.standard_normal((MID, MID, 1, 1)) / np.sqrt(MID)),
            bf16(rng.standard_normal((c, MID, 3, 3)) * 0.05))


@pytest.mark.parametrize("nets", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_chain_w2t_preparation(mode, nets):
    rng = np.random.RandomState(nets)
    weights = [net_weights(rng) for _ in range(nets)]
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    B, c = 1, 3
    chains = []
    for w1, w2, w3 in weights:
        s = lambda *shape: torch.rand(*shape)
        chains.append(tuple(t.to(dt) for t in (
            torch.ones(B, c, H, W), s(B, c, H, W), s(B, MID, H, W), s(B, MID, H, W),
            torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(w3))))
    op = fc.chain_operands(chains, torch.ones(4))
    assert op["mode"] == mode and fc.mid_weight_dtype(mode) == dt
    t = op["W2T"]
    want = torch.stack([ig.transpose_weights(*(torch.from_numpy(a) for a in n))[1]
                        for n in weights])
    assert t.dtype == dt and t.shape == (nets, MID, MID, 1, 1)
    # the kernel reads w[net][m][k] at (net * MID + m) * MID + k
    assert t.is_contiguous() and t.stride() == (MID * MID, MID, 1, 1, 1)
    torch.testing.assert_close(t.float(), want, rtol=0, atol=0)


def _jax_bf16_dot(w, x):
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        return np.asarray(_make_dot("bf16")(jnp.asarray(w), jnp.asarray(x)))


@pytest.mark.parametrize("nets,s_dtype", [(2, "bf16"), (2, "f32"), (1, "bf16")])
def test_nc_jt_mid_plain_matches_jax(nets, s_dtype):
    rng = np.random.RandomState(nets + (s_dtype == "f32"))
    w2t = np.stack([ig.transpose_weights(*(torch.from_numpy(a) for a in net_weights(rng)))[1]
                    .numpy() for _ in range(nets)])
    t = bf16(rng.standard_normal((nets, MID, HW)))
    s1 = (1.0 / (1.0 + np.exp(-rng.standard_normal((nets, MID, HW))))).astype(np.float32)
    if s_dtype == "bf16":
        s1 = bf16(s1)
    ref = np.stack([
        np.asarray(jnp.asarray(_jax_bf16_dot(w2t[n, :, :, 0, 0], t[n]) * s1[n])
                   .astype(jnp.bfloat16).astype(jnp.float32)) for n in range(nets)])
    sdt = torch.bfloat16 if s_dtype == "bf16" else torch.float32
    args = lambda w: (torch.from_numpy(t), w, torch.from_numpy(s1).to(sdt))
    out = torch.zeros(nets, MID, HW)
    fc._nc_jt_mid_plain(*args(torch.from_numpy(w2t).to(torch.bfloat16)), "bf16", out, H, W)
    err = rel_norm(out.numpy(), ref)
    ctrl_out = torch.zeros(nets, MID, HW)
    fc._nc_jt_mid_plain(*args(torch.from_numpy(w2t)), "f32", ctrl_out, H, W)
    ctrl = rel_norm(ctrl_out.numpy(), ref)
    assert err <= CHAIN_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("nets", [2, 4])
@pytest.mark.parametrize("act", ["id", "swish", "dswish"])
def test_fp_conv_mid_plain_matches_jax(act, nets):
    rng = np.random.RandomState(10 * nets + len(act))
    w2 = np.stack([net_weights(rng)[1] for _ in range(nets)])
    inp = rng.standard_normal((nets, MID, HW)).astype(np.float32)
    inh = rng.standard_normal((nets, MID, HW)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((nets, MID))).astype(np.float32)
    beta = (1.0 + 0.2 * rng.standard_normal(nets)).astype(np.float32)
    with_bias = act == "swish"  # h2 = W2 swish(h1) + b2; th2 and the W2^T products have none
    ref = []
    for n in range(nets):
        x, h, b = jnp.asarray(inp[n]), jnp.asarray(inh[n]), jnp.float32(beta[n])
        a = _swish(x, b) if act == "swish" else x * _dswish(h, b) if act == "dswish" else x
        y = _jax_bf16_dot(w2[n, :, :, 0, 0], np.asarray(a))
        ref.append(y + bias[n][:, None] if with_bias else y)
    ref = np.stack(ref)

    def run(w, mode):
        out = torch.zeros(nets, MID, HW)
        ff._fp_conv_mid_plain(torch.from_numpy(inp), torch.from_numpy(inh), w,
                              torch.from_numpy(bias) if with_bias else None,
                              torch.from_numpy(beta), act, mode, out, H, W)
        return out.numpy()

    err = rel_norm(run(torch.from_numpy(w2), "bf16"), ref)
    ctrl = rel_norm(run(torch.from_numpy(w2), "f32"), ref)
    assert err <= FINAL_TOL < ctrl, (err, ctrl)
