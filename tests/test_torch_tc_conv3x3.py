"""The re-attachment's last cotangent product ``t0 = C1^T (t1 swish'(h1))``
of mode bf16 on the CPU: the plain version ``_rv_conv3x3_out_plain``, which
its tensor-core kernel (``csrc/conv3x3_out_tc.cuh``) is held against on the
card, and ``ops/sum_order.py::rv_conv3x3_out_exact`` (the same product
summed in float64, rounded once: the re-attachment's sum-order floor of
``chip_smoke.py`` phase 6), each against the JAX package's product.

The JAX side is ``_net_vjp_in_kernel``
(``implicit_normalizing_flows_tpu/ops/fused_solve.py``), the body of the
``fused_reattach_vjp`` Pallas kernel, inside a ``pallas_call`` in interpret
mode, on one net of a JAX block (idim 16, c 3 and 12, 8x8, no preact, so
``d_h`` is ``t0``), with ``_make_dot("bf16")`` wrapped to record its own
``t1`` and ``h1``. The port's product runs on
those, with the net's effective ``w1`` flipped and transposed; its output
is held to JAX's ``t0`` by rel_norm at 2e-5 (the suite's limit for an
unrounded bf16 product), and the control, the plain version in mode f32 on
the same inputs, must read above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.fused_solve import prep_weight

from test_torch_backward_solve import make_blocks, rel_norm

TOL = 2e-5
HW_SIDE = 8


def _jax_t0(c):
    """(t1, h1, t0, data) of net x of a JAX block, per example: JAX's own
    intermediates t1 (mid, HW) and pre-activation h1, and the product t0
    (c, HW), from ``_net_vjp_in_kernel`` inside a ``pallas_call`` in
    interpret mode; with the net's conv_forward_data."""
    from jax.experimental import pallas as pl

    jblock, v, _, x = make_blocks(c, HW_SIDE, preact=False)
    data = jblock.nnet_x.conv_forward_data({"params": v["params"]["nnet_x"],
                                            "state": v["state"]["nnet_x"]})
    rng = np.random.RandomState(11)
    u = rng.standard_normal(x.shape).astype(np.float32)
    c8, HW = max(8, -(-c // 8) * 8), HW_SIDE * HW_SIDE
    mats, tmats = jfs._prep_fwd(data, c8), jfs._prep_jt(data, c8, jnp.float32)
    mid = mats[1].shape[0]
    betas = jnp.asarray(data["betas"], jnp.float32)

    def kernel(h_ref, cot_ref, beta_ref, *refs):
        ms, tms = tuple(r[:] for r in refs[:6]), tuple(r[:] for r in refs[6:9])
        dot, seen = jfs._make_dot("bf16"), {}

        def rec(a, m):  # the kernel's dot, recording t1 and h1
            y = dot(a, m)
            if a is ms[0]:
                seen["h1"] = y + ms[3]  # h1 = dot(m1, a0sh) + b1
            elif a is tms[1]:
                seen["t1"] = y          # t1 = dot(m2t, t2h)
            return y

        d_h, _ = jfs._net_vjp_in_kernel(
            jfs._make_shifted(HW_SIDE, HW_SIDE, 1), rec, ms, tms, beta_ref[0], beta_ref[1],
            beta_ref[2], False, c8, HW, h_ref[:], cot_ref[:], want_dh=True)
        refs[9][:], refs[10][:], refs[11][:] = seen["t1"], seen["h1"], d_h

    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((mid, HW), (mid, HW), (c8, HW))]
    call = pl.pallas_call(kernel, out_shape=shapes, interpret=True)
    out = []
    for b in range(x.shape[0]):
        h = jfs._pad_c(jnp.asarray(x[b:b + 1]), c8)[0]
        cot = jfs._pad_c(jnp.asarray(u[b:b + 1]), c8)[0]
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            t1, h1, d_h = call(h, cot, betas, *mats, *tmats)
        out.append((np.asarray(t1), np.asarray(h1), np.asarray(d_h)[:c]))
    t1, h1, t0 = (np.stack(a) for a in zip(*out))
    return t1, h1, t0, data


@pytest.mark.parametrize("c", [3, 12])
@pytest.mark.parametrize("fn", ["plain", "exact"])
def test_rv_conv3x3_out_matches_jax(c, fn):
    t1, h1, t0, data = _jax_t0(c)
    B, mid, HW = t1.shape
    w = {k: torch.from_numpy(np.array(data[k])) for k in ("w1", "w2", "w3")}
    w1t = ig.transpose_weights(w["w1"], w["w2"], w["w3"])[2]
    beta1 = torch.tensor(float(data["betas"][1]))
    idx = torch.arange(B, dtype=torch.int32)
    cnt = torch.tensor([B], dtype=torch.int32)
    product = {"plain": ig._rv_conv3x3_out_plain, "exact": so.rv_conv3x3_out_exact}[fn]

    def run(f, mode):
        out = torch.zeros(B, c * HW)
        f(torch.from_numpy(t1), torch.from_numpy(h1), beta1, idx, cnt,
          prep_weight(w1t, mode), mode, out, HW_SIDE, HW_SIDE)
        return out.numpy().reshape(t0.shape)

    err = rel_norm(run(product, "bf16"), t0)
    ctrl = rel_norm(run(ig._rv_conv3x3_out_plain, "f32"), t0)
    assert err <= TOL < ctrl, (err, ctrl)
