"""The backward solve's residual ``u + s0 * C1^T t - grad`` of mode bf16 on
the CPU: ``ops/sum_order.py``'s ``jt_conv3x3_out_exact`` (``C1^T t`` summed
in float64, rounded once: the backward solve's sum-order floor of
``chip_smoke.py`` phase 6) and ``jt_conv3x3_out_tiled`` (summed in the order
of the tensor-core kernel, ``csrc/conv3x3_out_tc.cuh``: per chunk of 64 mid
channels, and within it per tap, a fresh float32 partial added to the sum),
which stands in for that kernel here.

* Each against the JAX package's residual: ``_make_apply_jt``
  (``implicit_normalizing_flows_tpu/ops/fused_solve.py``), the J^T of the
  ``fused_backward_solve`` Pallas kernel, run inside a ``pallas_call`` in
  interpret mode as that kernel's ``resid = u + apply_JT(u) - grad``, on net
  z of a JAX block (idim 16, c 3 and 12, 8x8, preact on and off), with its
  last product's bf16 weight dot wrapped to record its own input ``t``. The
  port's function runs on that ``t`` with the net's ``w1`` flipped and
  transposed and JAX's own s0; it is held to JAX's residual by rel_norm
  over the product's part (residual - (u - grad)) at 2e-5 (the suite's
  limit for an unrounded bf16 product), and the control, the plain version
  in mode f32 on the same inputs, must read above it.
* The whole backward solve with ``jt_conv3x3_out_tiled`` (the plain solve
  otherwise) against JAX's ``fused_backward_solve`` in interpret mode, at
  ``tests/test_torch_backward_solve.py``'s tolerances (bf16: rel_norm 1e-3
  with the f32 control above it).
* A partial active list: count 2 of 4 under a permuted idx, the live
  examples against the plain version within 2e-5 of their largest entry,
  the dead examples' rows of out bitwise untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_tpu.ops.fused_chain import (conv1x1_transpose_mat,
                                                             conv3_transpose_mats,
                                                             conv3_transpose_mats_cout)
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.fused_solve import prep_weight

from test_torch_backward_solve import (BF16_TOL, KW, jax_chain_data, make_blocks, rel_norm,
                                       to_torch)

TOL = 2e-5
HW_SIDE = 8
FNS = {"exact": so.jt_conv3x3_out_exact, "tiled": so.jt_conv3x3_out_tiled}


def _jax_resid(c, preact):
    """(t, resid, u, grad, chain data) of net z of a JAX block, per example:
    JAX's own input t (mid, HW) of the last J^T product and its residual u +
    J^T u - grad (c, HW), from ``_make_apply_jt`` inside a ``pallas_call``
    in interpret mode, in mode bf16."""
    from jax.experimental import pallas as pl

    jblock, v, _, x = make_blocks(c, HW_SIDE, preact)
    rng = np.random.RandomState(12)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    u = rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "bf16")
    s0, s1, s2, w1, w2, w3 = cd
    c8, HW = max(8, -(-c // 8) * 8), HW_SIDE * HW_SIDE
    bf = jnp.bfloat16
    mats = (conv3_transpose_mats(w3.astype(bf), c8), conv1x1_transpose_mat(w2.astype(bf)),
            conv3_transpose_mats_cout(w1.astype(bf), c8))
    mid = mats[1].shape[0]
    wdot = jfs._make_wdot

    def kernel(u_ref, g_ref, s0_ref, s1_ref, s2_ref, m3_ref, m2_ref, m1_ref, t_ref, r_ref):
        m3, m2, m1 = m3_ref[:], m2_ref[:], m1_ref[:]
        seen = {}

        def rec_wdot(mode, m, **kw):  # the last product's dot, recording its input
            d = wdot(mode, m, **kw)
            if m is not m1:
                return d
            return lambda a: (seen.__setitem__("t", a), d(a))[1]

        jfs._make_wdot = rec_wdot
        try:
            apply_jt = jfs._make_apply_jt(jfs._make_shifted(HW_SIDE, HW_SIDE, 1), "bf16", m3,
                                          m2, m1, s0_ref[:].astype(jnp.float32),
                                          s1_ref[:].astype(jnp.float32),
                                          s2_ref[:].astype(jnp.float32), c8, HW)
        finally:
            jfs._make_wdot = wdot
        uu = u_ref[:]
        r_ref[:] = uu + apply_jt(uu) - g_ref[:]
        t_ref[:] = seen["t"]

    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((mid, HW), (c8, HW))]
    call = pl.pallas_call(kernel, out_shape=shapes, interpret=True)
    pad = lambda a, b: jfs._pad_c(jnp.asarray(a[b:b + 1]), c8)[0].reshape(c8, HW)
    out = []
    for b in range(x.shape[0]):
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            t, r = call(pad(u, b), pad(grad, b), pad(s0, b), s1[b].reshape(mid, HW),
                        s2[b].reshape(mid, HW), *mats)
        out.append((np.asarray(t), np.asarray(r)[:c]))
    t, resid = (np.stack(a) for a in zip(*out))
    return t, resid, u, grad, cd


def _run(fn, t, cd, u, grad, mode, idx=None, count=None, out=None):
    """fn (a jt_conv3x3_out version) on JAX's t with the chain data's s0 and
    w1: out (B, c*H*W)."""
    B = t.shape[0]
    s0 = to_torch(cd)[0].reshape(B, -1)
    w = [torch.from_numpy(np.array(cd[k], np.float32)) for k in (3, 4, 5)]
    w1t = ig.transpose_weights(*w)[2]
    idx = torch.arange(B, dtype=torch.int32) if idx is None else idx
    count = torch.tensor([B], dtype=torch.int32) if count is None else count
    out = torch.zeros(B, s0.shape[1]) if out is None else out
    fn(torch.from_numpy(t), idx, count, prep_weight(w1t, mode), s0, mode,
       torch.from_numpy(u).reshape(B, -1), torch.from_numpy(grad).reshape(B, -1), out,
       HW_SIDE, HW_SIDE)
    return out


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("c", [3, 12])
def test_jt_conv3x3_out_matches_jax(c, preact, fn):
    t, resid, u, grad, cd = _jax_resid(c, preact)
    ref = resid.reshape(resid.shape[0], -1)
    base = (u - grad).reshape(ref.shape)  # the product's part is resid - base
    err = rel_norm(_run(FNS[fn], t, cd, u, grad, "bf16").numpy(), ref, base)
    ctrl = rel_norm(_run(ig._jt_conv3x3_out_plain, t, cd, u, grad, "f32").numpy(), ref, base)
    assert err <= TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("c,hw,preact,threshold", [(3, 16, True, 4), (12, 8, False, 8)])
def test_backward_solve_with_tiled_jt_conv3x3_out_matches_jax(c, hw, preact, threshold):
    jblock, v, _, x = make_blocks(c, hw, preact)
    rng = np.random.RandomState(2)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "bf16")
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = np.asarray(jfs.fused_backward_solve(jnp.asarray(grad), cd, threshold=threshold,
                                                  mode="bf16", interpret=True, reps=1, **KW))
    ops = dict(ig._PLAIN, jt_conv3x3_out=so.jt_conv3x3_out_tiled)
    got = ig._backward_solve(torch.from_numpy(grad), to_torch(cd), ops, threshold=threshold,
                             mode="bf16", **KW)
    assert bool(torch.isfinite(got.u).all()) and not bool(got.prot_break.any())
    assert int(got.nstep.max()) == threshold  # eps 1e-10: the whole budget
    control = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd),
                                            threshold=threshold, mode="f32", **KW)
    err = rel_norm(got.u.numpy(), ref, grad)
    ctrl = rel_norm(control.u.numpy(), ref, grad)
    assert err <= BF16_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_jt_conv3x3_out_partial_list(fn):
    jblock, v, _, x = make_blocks(3, HW_SIDE, True, B=4)
    rng = np.random.RandomState(5)
    B = x.shape[0]
    cd = jax_chain_data(jblock, v, x, "bf16")
    mid = cd[4].shape[0]
    t = rng.standard_normal((B, mid, HW_SIDE * HW_SIDE)).astype(np.float32)
    u, grad = (rng.standard_normal(x.shape).astype(np.float32) for _ in range(2))
    idx = torch.from_numpy(rng.permutation(B).astype(np.int32))
    count = torch.tensor([2], dtype=torch.int32)
    outs = [_run(f, t, cd, u, grad, "bf16", idx, count, torch.full((B, 3 * 64), -7.25))
            for f in (FNS[fn], ig._jt_conv3x3_out_plain)]
    live, dead = idx[:2].long(), idx[2:].long()
    got, ref = outs[0][live], outs[1][live]
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    assert torch.equal(outs[0][dead], torch.full((2, 3 * 64), -7.25))
