"""The backward solve's first J^T stage ``jt_conv3x3_in`` (``t = C3^T u[idx[s]]
* s2[idx[s]]`` on an active list) of mode bf16 on the CPU. On the card it
runs on the c -> mid tensor-core kernel (``csrc/conv3x3_in_tc.cuh``,
epilogue ``EPI_SCALE``), which sums the im2col's k = ci * 9 + ky * 3 + kx in
K tiles of 16, each into a fresh float32 partial, scales by s2 of the
slot's example unrounded, and returns at once in the blocks of dead slots.
``ops/sum_order.py``'s ``jt_conv3x3_in_tiled`` sums that way and stands in
for the kernel here; ``jt_conv3x3_in_exact`` (the product summed in float64,
rounded once) reads the backward solve's sum-order floor of
``chip_smoke.py`` phase 6.

* Each against the JAX package's first J^T stage ``d3(u9) * s2`` of
  ``_make_apply_jt`` (``implicit_normalizing_flows_tpu/ops/fused_solve.py``),
  run inside a ``pallas_call`` in interpret mode with the next stage's bf16
  weight dot wrapped to record its input, on net z of a JAX block (idim 16,
  c 3 and 12, 8x8, preact on and off): by rel_norm at 2e-5 (the suite's
  limit for an unrounded bf16 product), the control, the plain version in
  mode f32 on the same inputs, above it.
* ``jt_conv3x3_in_exact`` against float64 numpy: the epilogue ``p * s2`` of
  the float32 rounding of the float64 product (or of a float32 beside it),
  nearly all to the bit, s2 bfloat16 or float32, on a permuted list.
* ``jt_conv3x3_in_tiled`` sums in the kernel's order: on inputs built so
  that one output's K tiles are {+2^25} and {-2^25, +1}, that order reads
  0, where the exact sum and a k-ordered float32 sum read 1.
* A partial permuted active list: count 2 of 4, the live slots (reading
  example idx[s]) against the plain version within 2e-5 of their largest
  entry, the dead slots bitwise untouched.
* The whole backward solve with the tiled 3a (and with the tiled 3a and 3c
  together) against JAX's ``fused_backward_solve`` in interpret mode, at
  ``tests/test_torch_backward_solve.py``'s tolerances (bf16: rel_norm 1e-3
  with the f32 control above it).
* W3^T cast once per solve to bfloat16 in mode bf16 (float32 in mode f32),
  exactly, and handed to every iteration's ``jt_conv3x3_in``.
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

from test_torch_backward_solve import (BF16_TOL, KW, jax_chain_data, make_blocks, rel_norm,
                                       to_torch)
from test_torch_tc_conv3x3_in import _bf16, _im2col64, _one_of

TOL = 2e-5
HS = 8
HW = HS * HS
FNS = {"exact": so.jt_conv3x3_in_exact, "tiled": so.jt_conv3x3_in_tiled}
SENTINEL = -7.25


def _jax_first_stage(c, preact):
    """(t2, u, chain data) of net z of a JAX block in mode bf16: JAX's own
    first J^T stage t2 = d3(u9) * s2 (B, mid, HW) of each example, the
    input of the next stage's dot in ``_make_apply_jt`` inside a
    ``pallas_call`` in interpret mode."""
    from jax.experimental import pallas as pl

    jblock, v, _, x = make_blocks(c, HS, preact)
    rng = np.random.RandomState(13)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    u = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "bf16")
    s0, s1, s2, w1, w2, w3 = cd
    c8 = max(8, -(-c // 8) * 8)
    bf = jnp.bfloat16
    mats = (conv3_transpose_mats(w3.astype(bf), c8), conv1x1_transpose_mat(w2.astype(bf)),
            conv3_transpose_mats_cout(w1.astype(bf), c8))
    mid = mats[1].shape[0]
    wdot = jfs._make_wdot

    def kernel(u_ref, s0_ref, s1_ref, s2_ref, m3_ref, m2_ref, m1_ref, t_ref):
        m3, m2, m1 = m3_ref[:], m2_ref[:], m1_ref[:]
        seen = {}

        def rec_wdot(mode, m, **kw):  # the second stage's dot, recording its input
            d = wdot(mode, m, **kw)
            if m is not m2:
                return d
            return lambda a: (seen.__setitem__("t", a), d(a))[1]

        jfs._make_wdot = rec_wdot
        try:
            apply_jt = jfs._make_apply_jt(jfs._make_shifted(HS, HS, 1), "bf16", m3, m2, m1,
                                          s0_ref[:].astype(jnp.float32),
                                          s1_ref[:].astype(jnp.float32),
                                          s2_ref[:].astype(jnp.float32), c8, HW)
        finally:
            jfs._make_wdot = wdot
        apply_jt(u_ref[:])
        t_ref[:] = seen["t"]

    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((mid, HW), jnp.float32),
                          interpret=True)
    pad = lambda a, b: jfs._pad_c(jnp.asarray(a[b:b + 1]), c8)[0].reshape(c8, HW)
    out = []
    for b in range(x.shape[0]):
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            t = call(pad(u, b), pad(s0, b), s1[b].reshape(mid, HW), s2[b].reshape(mid, HW),
                     *mats)
        out.append(np.asarray(t))
    return np.stack(out), u, cd


def _run(fn, u, w3t, s2, mode, idx=None, count=None, out=None):
    """fn (a jt_conv3x3_in version) on u with w3t prepared as the backward
    solve prepares it: out (B, mid, H*W) by slot."""
    B = u.shape[0]
    wp = ig.prep_mid_weight(w3t, mode)
    idx = torch.arange(B, dtype=torch.int32) if idx is None else idx
    count = torch.tensor([B], dtype=torch.int32) if count is None else count
    out = torch.zeros(B, w3t.shape[0], HW) if out is None else out
    fn(u, idx, count, wp, s2.reshape(out.shape), mode, out)
    return out


def _w3t(cd):
    w = [torch.from_numpy(np.array(cd[k], np.float32)) for k in (3, 4, 5)]
    return ig.transpose_weights(*w)[0]


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("c", [3, 12])
def test_jt_conv3x3_in_matches_jax(c, preact, fn):
    t2, u, cd = _jax_first_stage(c, preact)
    s2 = to_torch(cd)[2]
    got = _run(FNS[fn], torch.from_numpy(u), _w3t(cd), s2, "bf16").numpy()
    ctrl = _run(ig._jt_conv3x3_in_plain, torch.from_numpy(u), _w3t(cd), s2, "f32").numpy()
    err, control = rel_norm(got, t2), rel_norm(ctrl, t2)
    assert err <= TOL < control, (err, control)


def _operands(c, mid, s_bf16, seed):
    """u (B, c, HS, HS) and W3T (mid, c, 3, 3) of bfloat16 values, s2 (B,
    mid, HW) bfloat16 or float32, B 4."""
    rng = np.random.RandomState(seed)
    u = torch.from_numpy(_bf16(rng.standard_normal((4, c, HS, HS))))
    w3t = torch.from_numpy(_bf16(0.1 * rng.standard_normal((mid, c, 3, 3))))
    s2 = torch.from_numpy((0.5 + rng.random_sample((4, mid, HW))).astype(np.float32))
    return u, w3t, s2.bfloat16() if s_bf16 else s2


@pytest.mark.parametrize("s_bf16", [True, False])
@pytest.mark.parametrize("c", [3, 48])
def test_jt_conv3x3_in_exact_is_the_float64_product(c, s_bf16):
    mid = 64
    u, w3t, s2 = _operands(c, mid, s_bf16, 5 + c)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    got = _run(so.jt_conv3x3_in_exact, u, w3t, s2, "bf16", idx).numpy()
    cols = _im2col64(u.numpy()[idx.numpy()])  # (B, 9 c, HW), slot order
    p64 = np.einsum("mk,bkp->bmp", w3t.double().numpy().reshape(mid, -1), cols)
    s2f = s2.float().numpy()[idx.numpy()]
    _one_of([got], p64, lambda p: [p * s2f])  # one float32 multiply


def test_jt_conv3x3_in_tiled_sums_k_tiles_of_16():
    """k = ci * 9 + ky * 3 + kx: k 0 (ci 0, tap 0) in the first K tile;
    k 16 and 17 (ci 1, taps 7 and 8) in the second."""
    u, w3t = torch.zeros(1, 2, HS, HS), torch.zeros(1, 2, 3, 3)
    u[0, 0, 3, 3], w3t[0, 0, 0, 0] = 2.0**13, 2.0**12  # output (4, 4), tap 0: 2^25
    u[0, 1, 5, 4], w3t[0, 1, 2, 1] = 2.0**13, -(2.0**12)  # tap 7: -2^25
    u[0, 1, 5, 5], w3t[0, 1, 2, 2] = 1.0, 1.0  # tap 8
    s2 = torch.ones(1, 1, HW)
    at = lambda fn: float(_run(fn, u, w3t, s2, "bf16")[0, 0, 4 * HS + 4])
    assert at(so.jt_conv3x3_in_tiled) == 0.0  # -2^25 + 1 rounds within its tile
    assert at(so.jt_conv3x3_in_exact) == 1.0
    k_ordered = np.float32(0.0)  # one float32 sum over k in order
    terms = torch.nn.functional.unfold(u, 3, padding=1)[0, :, 4 * HS + 4] * w3t.reshape(-1)
    for v in terms.numpy():
        k_ordered = np.float32(k_ordered + v)
    assert k_ordered == 1.0


@pytest.mark.parametrize("fn", sorted(FNS))
def test_jt_conv3x3_in_partial_list(fn):
    u, w3t, s2 = _operands(12, 64, True, 9)
    B = u.shape[0]
    idx = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    count = torch.tensor([2], dtype=torch.int32)
    outs = [_run(f, u, w3t, s2, "bf16", idx, count, torch.full((B, 64, HW), SENTINEL))
            for f in (FNS[fn], ig._jt_conv3x3_in_plain)]
    got, ref = outs[0][:2], outs[1][:2]
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    # the live slots read their examples: slot 0 is example 3's
    want = torch.nn.functional.conv2d(u[3:4], w3t, padding=1).reshape(64, HW) * s2[3].float()
    assert float((ref[0] - want).abs().max() / want.abs().max()) <= TOL
    assert torch.equal(outs[0][2:], torch.full((2, 64, HW), SENTINEL))  # dead slots untouched


@pytest.mark.parametrize("stages", ["3a", "3a+3c"])
@pytest.mark.parametrize("c,hw,preact,threshold", [(3, 16, True, 4), (12, 8, False, 8)])
def test_backward_solve_with_tiled_jt_conv3x3_in_matches_jax(c, hw, preact, threshold, stages):
    jblock, v, _, x = make_blocks(c, hw, preact)
    rng = np.random.RandomState(2)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "bf16")
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = np.asarray(jfs.fused_backward_solve(jnp.asarray(grad), cd, threshold=threshold,
                                                  mode="bf16", interpret=True, reps=1, **KW))
    ops = dict(ig._PLAIN, jt_conv3x3_in=so.jt_conv3x3_in_tiled)
    if stages == "3a+3c":
        ops["jt_conv3x3_out"] = so.jt_conv3x3_out_tiled
    got = ig._backward_solve(torch.from_numpy(grad), to_torch(cd), ops, threshold=threshold,
                             mode="bf16", **KW)
    assert bool(torch.isfinite(got.u).all()) and not bool(got.prot_break.any())
    assert int(got.nstep.max()) == threshold  # eps 1e-10: the whole budget
    control = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd),
                                            threshold=threshold, mode="f32", **KW)
    err = rel_norm(got.u.numpy(), ref, grad)
    ctrl = rel_norm(control.u.numpy(), ref, grad)
    assert err <= BF16_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_backward_solve_casts_w3t_once(monkeypatch, mode):
    jblock, v, _, x = make_blocks(3, HS, True)
    cd = to_torch(jax_chain_data(jblock, v, x, mode))
    grad = torch.from_numpy(np.random.RandomState(4).standard_normal(x.shape).astype(np.float32))
    seen, casts = [], []
    prep = ig.prep_mid_weight
    monkeypatch.setattr(ig, "prep_mid_weight",
                        lambda w, m: casts.append(tuple(w.shape)) or prep(w, m))
    ops = dict(ig._PLAIN, jt_conv3x3_in=lambda u, i, n, wp, *a: seen.append(wp)
               or ig._jt_conv3x3_in_plain(u, i, n, wp, *a))
    ig._backward_solve(grad, cd, ops, threshold=4, mode=mode, **KW)
    w3t = ig.transpose_weights(*(w.float() for w in cd[3:6]))[0]
    assert casts.count(tuple(w3t.shape)) == 1  # once per solve
    assert len(seen) >= 2 and all(wp is seen[0] for wp in seen)  # every iteration's
    w, lo = seen[0]
    assert lo is None and w.dtype == ig.mid_weight_dtype(mode) and w.is_contiguous()
    torch.testing.assert_close(w.float(), w3t, rtol=0, atol=0)
