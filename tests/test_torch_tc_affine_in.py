"""The c -> mid 3x3 products of the final pair (``fp_conv_in``: ``h1 = W1 a0
+ b1``, ``th1 = W1 ta0``, ``r2 = C3^T acc``, both nets in one launch) and of
the re-attachment (``rv_conv3x3_in``: ``h1 = W1 [swish](h) + b1``, ``t2 =
+-C3^T u``, on an active list) of mode bf16 on the CPU. On the card both run
on the c -> mid tensor-core kernels of ``csrc/conv3x3_in_tc.cuh``, the input
transform (swish, or swish' of the pre-activation times the input) once per
loaded element, the operands rounded to bf16:

* ``rv_conv3x3_in`` on ``conv3x3_in_tc_kernel``'s ``EPI_AFFINE``: K tiles of
  16, each a fresh float32 partial, then alpha * acc + bias in float32.
  ``ops/sum_order.py``'s ``rv_conv3x3_in_tiled`` sums that way and stands in
  for it here.
* ``fp_conv_in`` on ``conv3x3_in_dmma_kernel``: the exact products summed in
  float64 on the FP64 tensor cores and rounded once, then + bias[net].
  ``fp_conv_in_exact`` sums that way and stands in for it here;
  ``fp_conv_in_tiled`` is the order it does not take (``EPI_AFFINE``'s).

The exact versions also read the sum-order floors of ``chip_smoke.py``
phases 9 and 6; the plain versions (float32 sums) are what the kernels are
held against on the card.

* Every form against the JAX package's own product, recorded from the
  Pallas kernels' bodies inside a ``pallas_call`` in interpret mode with
  ``_make_dot("bf16")`` wrapped: h1, th1 and r2 of ``_final_T_in_kernel``
  and ``_final_grads_in_kernel`` on both nets (each with its own kernels,
  slopes and biases), h1 and t2 of ``_net_vjp_in_kernel`` on net x (cot u)
  and net z (cot -u: alpha -1), by rel_norm at 2e-5 (the suite's limit for
  an unrounded bf16 product), the control, the plain version in mode f32 on
  the same inputs, above it.
* The exact versions against float64 numpy: the epilogue of the float32
  rounding of the float64 product (or of a float32 beside it).
* The exact versions keep what a float32 sum loses: on inputs built so that
  one output's products over k are +2^25, +1, -2^25, they read 1 where a
  k-ordered float32 sum reads 0.
* The tiled versions sum in K tiles of 16: on inputs built so that one
  output's K tiles are {+2^25} and {-2^25, +1}, they read 0, where the exact
  sum and a k-ordered float32 sum read 1.
* A partial permuted active list for rv_conv3x3_in: the live slots read
  example idx[s], the dead slots are bitwise untouched.
* Two nets with distinct slopes and biases: fp_conv_in on both nets' stacked
  examples equals the launch on each net alone, to the bit.
* Phase 9's reference (the final pair with ``fp_conv_mid`` and
  ``fp_conv_in`` summed exactly): the pair with ``fp_conv_mid`` in its
  kernel's order (K tiles of 64) within ``FINAL_TOL`` 1e-5 of it, the f32
  control above it.
* The whole final pair with the exact 5a (and the tiled 5c) and the whole
  re-attachment with the exact or the tiled 4a (and the tiled 4b) against
  JAX's
  ``fused_final_pair`` / ``fused_reattach_vjp`` in interpret mode, at
  ``tests/test_torch_final_pair.py``'s and
  ``tests/test_torch_reattach_vjp.py``'s bf16 tolerance, controls above.
* The kernels cast once per call: W1 and W3^T to bfloat16 in mode bf16
  (float32 in mode f32), exactly, and each launch of a call reading that
  one tensor; the re-attachment's slope handed over as a one-element
  tensor on the device.
* The shapes the route takes (``fused_solve.check_conv3x3_tc`` with the c ->
  mid kernel's band) and those it refuses.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm
from test_torch_final_pair import LABELS, UNROUNDED, _inputs as _pair_inputs, _jax as _pair_jax
from test_torch_reattach_vjp import NAMES, _inputs as _re_inputs, _torch as _td
from test_torch_tc_conv3x3_in import _bf16, _im2col64, _one_of
from test_torch_tc_final_out import _port_pair
from test_torch_tc_order import FINAL_TOL, _pair as _order_pair

TOL = 2e-5
HS = 8
HW = HS * HS
FP_FNS = {"exact": so.fp_conv_in_exact, "tiled": so.fp_conv_in_tiled,
          "plain": ff._fp_conv_in_plain}
RV_FNS = {"exact": so.rv_conv3x3_in_exact, "tiled": so.rv_conv3x3_in_tiled,
          "plain": ig._rv_conv3x3_in_plain}
SENTINEL = -7.25


def _record(data, c, kernel, args, n_out):
    """JAX's own products of one net, per example: ``kernel`` (a Pallas
    kernel body taking ``dot`` as an argument) run inside a ``pallas_call``
    in interpret mode, mode bf16, with its dot wrapped to record h1 =
    dot(m1, .) + b1, then each later dot(m1, .) and dot(m3t, .) (the
    first ``n_out`` of them). ``args`` (B, c, HS, HS) arrays, the kernel's
    per-example inputs."""
    from jax.experimental import pallas as pl

    c8 = max(8, -(-c // 8) * 8)
    mats, tmats = jfs._prep_fwd(data, c8), jfs._prep_jt(data, c8, jnp.float32)
    mid = mats[1].shape[0]
    betas = jnp.asarray(data["betas"], jnp.float32)

    def body(beta_ref, *refs):
        ins = [r[:] for r in refs[:len(args)]]
        rest = refs[len(args):]
        ms, tms = tuple(r[:] for r in rest[:6]), tuple(r[:] for r in rest[6:9])
        dot, seen = jfs._make_dot("bf16"), []

        def rec(a, m):
            y = dot(a, m)
            if a is ms[0] or a is tms[0]:
                seen.append(y + ms[3] if a is ms[0] and not seen else y)
            return y

        kernel(jfs._make_shifted(HS, HS, 1), rec, ms, tms, beta_ref[0], beta_ref[1],
               beta_ref[2], *ins)
        for o, v in zip(rest[9:], seen):
            o[:] = v

    call = pl.pallas_call(body, out_shape=[jax.ShapeDtypeStruct((mid, HW), jnp.float32)] * n_out,
                          interpret=True)
    pad = lambda a, b: jfs._pad_c(jnp.asarray(a[b:b + 1]), c8)[0].reshape(c8, HW)
    out = []
    for b in range(args[0].shape[0]):
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            out.append([np.asarray(o) for o in call(betas, *(pad(a, b) for a in args), *mats,
                                                      *tmats)])
    return [np.stack(o) for o in zip(*out)]


@functools.lru_cache(maxsize=None)
def _jax_final(c, preact, which):
    """(h1, th1, r2) of both nets (net x's examples, then net z's), each (2
    B, mid, HW), from ``_final_T_in_kernel`` or ``_final_grads_in_kernel``,
    with the pair's inputs."""
    dx, dz, arrays, cot = _pair_inputs(c, preact)
    x, z, ex, ez, ax, az = arrays
    c8 = max(8, -(-c // 8) * 8)
    if which == "T":
        kern = lambda sh, dot, ms, tms, b0, b1, b2, h, e, a: jfs._final_T_in_kernel(
            sh, dot, ms, tms, b0, b1, b2, preact, c8, HW, h, e, a)
    else:
        kern = lambda sh, dot, ms, tms, b0, b1, b2, h, e, a: jfs._final_grads_in_kernel(
            sh, dot, ms, tms, b0, b1, b2, preact, c8, HW, h, e, a)
    nets = [_record(d, c, kern, (h, e, a), 3) for d, h, e, a in ((dx, x, ex, ax), (dz, z, ez, az))]
    return [np.concatenate(f) for f in zip(*nets)], (dx, dz, arrays)


def _port_final(fn, dx, dz, arrays, preact, mode):
    """fn (an fp_conv_in version) on both nets' stacked examples with the
    final pair's weights of mode: (h1, th1, r2), as its primal launches it."""
    wt = ff._weights([_td(dx), _td(dz)], mode, torch.float32)
    x, z, ex, ez, ax, az = (torch.from_numpy(a) for a in arrays)
    cat = lambda a, b: torch.cat([a, b]).contiguous()
    Hs, E, ACC = cat(x, z), cat(ex, ez), cat(ax, az)
    outs = [torch.zeros(Hs.shape[0], wt["w1"].shape[1], HW) for _ in range(3)]
    fn(Hs, None, wt["w1"], wt["b1"], wt["beta"][0], "swish" if preact else "id", mode, outs[0])
    fn(E, Hs, wt["w1"], None, wt["beta"][0], "dswish" if preact else "id", mode, outs[1])
    fn(ACC, None, wt["w3t"], None, None, "id", mode, outs[2])
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("fn", sorted(FP_FNS))
@pytest.mark.parametrize("which", ["T", "grads"])
@pytest.mark.parametrize("c,preact", [(3, True), (12, False)])
def test_fp_conv_in_matches_jax(c, preact, which, fn):
    want, (dx, dz, arrays) = _jax_final(c, preact, which)
    got = _port_final(FP_FNS[fn], dx, dz, arrays, preact, "bf16")
    ctrl = _port_final(ff._fp_conv_in_plain, dx, dz, arrays, preact, "f32")
    for name, g, k, w in zip(("h1", "th1", "r2"), got, ctrl, want):
        err, control = rel_norm(g, w), rel_norm(k, w)
        assert err <= TOL < control, (name, err, control)


@functools.lru_cache(maxsize=None)
def _jax_reattach(c, preact, net):
    """(h1, t2) of net x (at x, cot u) or net z (at z_hat, cot -u) from
    ``_net_vjp_in_kernel``, with the VJP's inputs."""
    x, z_hat, u, dx, dz, _ = _re_inputs(c, HS, preact)
    data, h, cot = (dx, x, u) if net == "x" else (dz, z_hat, -u)
    c8 = max(8, -(-c // 8) * 8)
    kern = lambda sh, dot, ms, tms, b0, b1, b2, hh, cc: jfs._net_vjp_in_kernel(
        sh, dot, ms, tms, b0, b1, b2, preact, c8, HW, hh, cc, want_dh=True)
    return _record(data, c, kern, (h, cot), 2), (h, u, data)


def _port_reattach(fn, h, u, data, csign, mode, idx=None, count=None, outs=None):
    """fn (an rv_conv3x3_in version) as the re-attachment launches it for
    one net: (h1, t2 = csign C3^T u), its kernels prepared once per VJP."""
    d = _td(data)
    w1, w3 = d["w1"].float(), d["w3"].float()
    w3t = ig.transpose_weights(w1, d["w2"].float(), w3)[0]
    wp1, wt3 = ig.prep_rv_mid_weight(w1, mode), ig.prep_rv_mid_weight(w3t, mode)
    bd = d["betas"].float().contiguous()
    B = h.shape[0]
    idx = torch.arange(B, dtype=torch.int32) if idx is None else idx
    count = torch.tensor([B], dtype=torch.int32) if count is None else count
    outs = [torch.zeros(B, w1.shape[0], HW) for _ in range(2)] if outs is None else outs
    preact = bool(data["preact"])
    fn(torch.as_tensor(h), idx, count, wp1, d["b1"].float(), 1.0, bd[0:1] if preact else None,
       "swish" if preact else "id", mode, outs[0])
    fn(torch.as_tensor(u), idx, count, wt3, None, csign, None, "id", mode, outs[1])
    return outs


@pytest.mark.parametrize("fn", sorted(RV_FNS))
@pytest.mark.parametrize("net", ["x", "z"])
@pytest.mark.parametrize("c,preact", [(3, True), (12, False)])
def test_rv_conv3x3_in_matches_jax(c, preact, net, fn):
    want, (h, u, data) = _jax_reattach(c, preact, net)
    csign = 1.0 if net == "x" else -1.0
    h, u = torch.from_numpy(h), torch.from_numpy(u)
    got = _port_reattach(RV_FNS[fn], h, u, data, csign, "bf16")
    ctrl = _port_reattach(ig._rv_conv3x3_in_plain, h, u, data, csign, "f32")
    for name, g, k, w in zip(("h1", "t2"), got, ctrl, want):
        err, control = rel_norm(g.numpy(), w), rel_norm(k.numpy(), w)
        assert err <= TOL < control, (name, err, control)


def _two_nets(c, mid, seed):
    """Both nets' stacked inputs x and h (2 NB, c, HS, HS), kernels (2, mid,
    c, 3, 3) of bfloat16 values, biases (2, mid) and slopes (2,), NB 2."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((4, c, HS, HS)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((4, c, HS, HS)).astype(np.float32))
    w = torch.from_numpy(_bf16(0.1 * rng.standard_normal((2, mid, c, 3, 3))))
    b = torch.from_numpy((0.1 * rng.standard_normal((2, mid))).astype(np.float32))
    return x, h, w, b, torch.tensor([1.3, 0.7])


@pytest.mark.parametrize("act", ["swish", "dswish"])
def test_fp_conv_in_exact_is_the_float64_product(act):
    c, mid = 12, 64
    x, h, w, b, beta = _two_nets(c, mid, 3)
    out = torch.zeros(4, mid, HW)
    bias = b if act == "swish" else None
    so.fp_conv_in_exact(x, h if act == "dswish" else None, w, bias, beta, act, "bf16", out)
    # the transform in float32 as the plain version takes it, then bf16
    a = torch.cat([ff._act(x[2 * n:2 * n + 2], h[2 * n:2 * n + 2], beta[n], act)
                   for n in range(2)])
    cols = _im2col64(_bf16(a.numpy()))
    wk = w.double().numpy().reshape(2, mid, -1)
    p64 = np.stack([wk[s // 2] @ cols[s] for s in range(4)])
    bb = np.zeros((4, mid, 1), np.float32) if bias is None else b.numpy()[[0, 0, 1, 1], :, None]
    _one_of([out.numpy()], p64, lambda p: [p + bb] if bias is not None else [p])


def test_rv_conv3x3_in_exact_is_the_float64_product():
    c, mid = 48, 64
    x, _, w, b, beta = _two_nets(c, mid, 5)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    out = torch.zeros(4, mid, HW)
    so.rv_conv3x3_in_exact(x, idx, torch.tensor([4], dtype=torch.int32), (w[0], None), b[0],
                           -1.0, beta[:1], "swish", "bf16", out)
    a = fs.swish(x.index_select(0, idx.long()), beta[:1])
    cols = _im2col64(_bf16(a.numpy()))
    p64 = np.einsum("mk,bkp->bmp", w[0].double().numpy().reshape(mid, -1), cols)
    _one_of([out.numpy()], p64, lambda p: [-p + b[0].numpy()[:, None]])  # alpha, then the bias


def _cancel_case():
    """One output (pixel (4, 4), channel 0) whose products over k = ci * 9
    + tap are 2^25 (k 0), 1 (k 1) and -2^25 (k 2): inp (1, 1, HS, HS), w
    (1, 1, 3, 3)."""
    u, w = torch.zeros(1, 1, HS, HS), torch.zeros(1, 1, 3, 3)
    u[0, 0, 3, 3], w[0, 0, 0, 0] = 2.0**13, 2.0**12  # tap 0
    u[0, 0, 3, 4], w[0, 0, 0, 1] = 1.0, 1.0  # tap 1
    u[0, 0, 3, 5], w[0, 0, 0, 2] = 2.0**13, -(2.0**12)  # tap 2
    return u, w


@pytest.mark.parametrize("kernel", ["fp_conv_in", "rv_conv3x3_in"])
def test_exact_keeps_what_a_float32_sum_loses(kernel):
    u, w = _cancel_case()
    out = torch.zeros(1, 1, HW)
    if kernel == "fp_conv_in":
        so.fp_conv_in_exact(u, None, w[None], None, None, "id", "bf16", out)
    else:
        so.rv_conv3x3_in_exact(u, torch.zeros(1, dtype=torch.int32),
                               torch.tensor([1], dtype=torch.int32), (w, None), None, 1.0, None,
                               "id", "bf16", out)
    assert float(out[0, 0, 4 * HS + 4]) == 1.0
    k_ordered = np.float32(0.0)  # one float32 sum over k in order: 2^25 + 1 rounds to 2^25
    terms = torch.nn.functional.unfold(u, 3, padding=1)[0, :, 4 * HS + 4] * w.reshape(-1)
    for v in terms.numpy():
        k_ordered = np.float32(k_ordered + v)
    assert k_ordered == 0.0


@pytest.mark.parametrize("kernel", ["fp_conv_in", "rv_conv3x3_in"])
def test_tiled_sums_k_tiles_of_16(kernel):
    """k = ci * 9 + ky * 3 + kx: k 0 (ci 0, tap 0) in the first K tile;
    k 16 and 17 (ci 1, taps 7 and 8) in the second."""
    u, w = torch.zeros(1, 2, HS, HS), torch.zeros(1, 2, 3, 3)
    u[0, 0, 3, 3], w[0, 0, 0, 0] = 2.0**13, 2.0**12  # output (4, 4), tap 0: 2^25
    u[0, 1, 5, 4], w[0, 1, 2, 1] = 2.0**13, -(2.0**12)  # tap 7: -2^25
    u[0, 1, 5, 5], w[0, 1, 2, 2] = 1.0, 1.0  # tap 8

    def at(order):
        out = torch.zeros(1, 1, HW)
        if kernel == "fp_conv_in":
            fn = so.fp_conv_in_tiled if order == "tiled" else so.fp_conv_in_exact
            fn(u, None, w[None], None, None, "id", "bf16", out)
        else:
            fn = so.rv_conv3x3_in_tiled if order == "tiled" else so.rv_conv3x3_in_exact
            fn(u, torch.zeros(1, dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
               (w, None), None, 1.0, None, "id", "bf16", out)
        return float(out[0, 0, 4 * HS + 4])

    assert at("tiled") == 0.0  # -2^25 + 1 rounds within its tile
    assert at("exact") == 1.0
    k_ordered = np.float32(0.0)  # one float32 sum over k in order
    terms = torch.nn.functional.unfold(u, 3, padding=1)[0, :, 4 * HS + 4] * w.reshape(-1)
    for v in terms.numpy():
        k_ordered = np.float32(k_ordered + v)
    assert k_ordered == 1.0


@pytest.mark.parametrize("fn", sorted(RV_FNS))
def test_rv_conv3x3_in_partial_list(fn):
    c, mid = 12, 64
    x, _, w, b, beta = _two_nets(c, mid, 9)
    idx = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    count = torch.tensor([2], dtype=torch.int32)
    outs = []
    for f in (RV_FNS[fn], ig._rv_conv3x3_in_plain):
        out = torch.full((4, mid, HW), SENTINEL)
        f(x, idx, count, (w[0], None), b[0], 1.0, beta[:1], "swish", "bf16", out)
        outs.append(out)
    got, ref = outs[0][:2], outs[1][:2]
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    # the live slots read their examples: slot 0 is example 3's
    want = (torch.nn.functional.conv2d(fs.swish(x[3:4], beta[0]).bfloat16().float(), w[0],
                                       padding=1) + b[0][None, :, None, None]).reshape(mid, HW)
    assert float((ref[0] - want).abs().max() / want.abs().max()) <= TOL
    assert torch.equal(outs[0][2:], torch.full((2, mid, HW), SENTINEL))  # dead slots untouched


@pytest.mark.parametrize("act", ["swish", "dswish"])
def test_fp_conv_in_two_nets_take_their_own_slopes_and_biases(act):
    x, h, w, b, beta = _two_nets(3, 64, 11)
    hh = h if act == "dswish" else None
    both = torch.zeros(4, 64, HW)
    so.fp_conv_in_exact(x, hh, w, b, beta, act, "bf16", both)
    for n in range(2):
        e = slice(2 * n, 2 * n + 2)
        one = torch.zeros(2, 64, HW)
        so.fp_conv_in_exact(x[e], None if hh is None else hh[e], w[n:n + 1], b[n:n + 1],
                            beta[n:n + 1], act, "bf16", one)
        assert torch.equal(both[e], one)
    # the nets differ: net 1's examples on net 0's kernel, slope and bias differ
    other = torch.zeros(2, 64, HW)
    so.fp_conv_in_exact(x[2:], None if hh is None else hh[2:], w[:1], b[:1], beta[:1], act,
                        "bf16", other)
    assert not torch.equal(both[2:], other)


@pytest.mark.parametrize("stages", ["5a", "5a+5c"])
@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_final_pair_with_exact_fp_conv_in_matches_jax(c, preact, stages):
    dx, dz, arrays, cot = _pair_inputs(c, preact)
    T_ref, g_ref = _pair_jax(dx, dz, arrays, cot, "bf16")
    ops = dict(ff._PLAIN, fp_conv_in=so.fp_conv_in_exact)
    if stages == "5a+5c":
        ops["fp_conv_out"] = so.fp_conv_out_tiled
    T_got, g_got = _port_pair(dx, dz, arrays, cot, "bf16", ops)
    T_ctl, g_ctl = _port_pair(dx, dz, arrays, cot, "f32", ff._PLAIN)
    for name, g, r, k in zip(["T_x", "T_z"] + LABELS, T_got + g_got, T_ref + g_ref,
                             T_ctl + g_ctl):
        err = rel_norm(g.numpy(), r)
        assert err <= TOL, (name, err)
        if name not in UNROUNDED:
            ctrl = rel_norm(k.numpy(), r)
            assert ctrl > TOL, (name, ctrl)


def _exact_reference(dx, dz, arrays, cot):
    return _order_pair(dx, dz, arrays, cot, "bf16", dict(
        ff._PLAIN, fp_conv_mid=so.fp_conv_mid_exact, fp_conv_in=so.fp_conv_in_exact))


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_kernels_order_within_final_tol_of_the_exact_reference(c, preact):
    dx, dz, arrays, cot = _pair_inputs(c, preact)
    ref = _exact_reference(dx, dz, arrays, cot)
    got = _order_pair(dx, dz, arrays, cot, "bf16", dict(
        ff._PLAIN, fp_conv_mid=so.fp_conv_mid_tiled, fp_conv_in=so.fp_conv_in_exact))
    worst = max((rel_norm(a.numpy(), b.numpy()), n) for (n, a), (_, b) in zip(got, ref))
    assert worst[0] <= FINAL_TOL, worst


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_f32_control_fails_the_exact_reference(c, preact):
    dx, dz, arrays, cot = _pair_inputs(c, preact)
    ref = _exact_reference(dx, dz, arrays, cot)
    ctrl = _order_pair(dx, dz, arrays, cot, "f32", ff._PLAIN)
    # b3's gradient is exactly zero on both sides: no product reaches it
    least = min((rel_norm(a.numpy(), b.numpy()), n) for (n, a), (_, b) in zip(ctrl, ref)
                if not n.endswith(".b3"))
    assert least[0] > FINAL_TOL, least


def _check_reattach(c, hw, preact, stages, rv_conv3x3_in):
    """The whole re-attachment with rv_conv3x3_in (and the tiled 4b under
    stages '4a+4b') against JAX's, the f32 control above the limit."""
    x, z_hat, u, dx, dz, _ = _re_inputs(c, hw, preact)
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = jfs.fused_reattach_vjp(jnp.asarray(x), jnp.asarray(z_hat), jnp.asarray(u), dx, dz,
                                     mode="bf16", interpret=True, reps=1)
    ops = dict(ig._PLAIN, rv_conv3x3_in=rv_conv3x3_in)
    if stages == "4a+4b":
        ops["rv_conv1x1_mid"] = so.rv_conv1x1_mid_tiled
    args = (torch.from_numpy(x), torch.from_numpy(z_hat), torch.from_numpy(u), _td(dx), _td(dz))
    got = ig._reattach_vjp(*args, ops, "bf16")
    ctrl = ig.fused_reattach_vjp_plain(*args, mode="f32")
    flat = lambda g: [("d_x", g[0])] + [(f"{n}.{k}", h[k]) for n, h in (("x", g[1]), ("z", g[2]))
                                        for k in NAMES]
    for (name, g), (_, k), (_, r) in zip(flat(got), flat(ctrl), flat(ref)):
        base = u if name == "d_x" else None
        r = np.asarray(r)
        err = rel_norm(g.numpy(), r, base)
        assert err <= TOL, (name, err)
        if name not in ("x.b3", "z.b3"):
            assert rel_norm(k.numpy(), r, base) > TOL, name


@pytest.mark.parametrize("stages", ["4a", "4a+4b"])
@pytest.mark.parametrize("c,hw,preact", [(3, 16, True), (12, 8, False)])
def test_reattach_with_exact_rv_conv3x3_in_matches_jax(c, hw, preact, stages):
    _check_reattach(c, hw, preact, stages, so.rv_conv3x3_in_exact)


@pytest.mark.parametrize("stages", ["4a", "4a+4b"])
@pytest.mark.parametrize("c,hw,preact", [(3, 16, True), (12, 8, False)])
def test_reattach_with_tiled_rv_conv3x3_in_matches_jax(c, hw, preact, stages):
    _check_reattach(c, hw, preact, stages, so.rv_conv3x3_in_tiled)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_final_pair_casts_fp_conv_in_kernels_once(monkeypatch, mode):
    dx, dz, arrays, cot = _pair_inputs(3, True)
    seen, calls = [], []
    weights = ff._weights
    monkeypatch.setattr(ff, "_weights", lambda *a: calls.append(1) or weights(*a))
    ops = dict(ff._PLAIN, fp_conv_in=lambda inp, inh, w, *a: seen.append(w)
               or ff._fp_conv_in_plain(inp, inh, w, *a))
    _port_pair(dx, dz, arrays, cot, mode, ops)
    assert len(calls) == 2  # once in the forward, once in the backward
    # forward: h1, th1 (w1), r2 (w3t); backward the same three
    assert len(seen) == 6 and seen[0] is seen[1] and seen[3] is seen[4]
    d = [_td(v) for v in (dx, dz)]
    w1 = torch.stack([v["w1"].float() for v in d])
    w3t = torch.stack([ig.transpose_weights(v["w1"].float(), v["w2"].float(),
                                            v["w3"].float())[0] for v in d])
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    for w, want in ((seen[0], w1), (seen[2], w3t), (seen[3], w1), (seen[5], w3t)):
        assert w.dtype == dt and w.is_contiguous()
        torch.testing.assert_close(w.float(), want.to(dt).float(), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_reattach_casts_rv_conv3x3_in_kernels_once(monkeypatch, mode):
    x, z_hat, u, dx, dz, _ = _re_inputs(3, HS, True)
    seen = []
    ops = dict(ig._PLAIN, rv_conv3x3_in=lambda inp, i, n, wp, bias, alpha, beta, act, *a:
               seen.append((wp, beta, act, alpha))
               or ig._rv_conv3x3_in_plain(inp, i, n, wp, bias, alpha, beta, act, *a))
    ig._reattach_vjp(torch.from_numpy(x), torch.from_numpy(z_hat), torch.from_numpy(u), _td(dx),
                     _td(dz), ops, mode)
    assert [a for *_, a in seen] == [1.0, 1.0, 1.0, -1.0]  # h1, t2 of net x, then of net z
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    for n, d in enumerate((_td(dx), _td(dz))):
        (w1, lo1), beta, act, _ = seen[2 * n]
        (w3t, lo3), beta_t, act_t, _ = seen[2 * n + 1]
        assert lo1 is None and lo3 is None and w1.dtype == w3t.dtype == dt
        want3 = ig.transpose_weights(d["w1"].float(), d["w2"].float(), d["w3"].float())[0]
        torch.testing.assert_close(w1.float(), d["w1"].float().to(dt).float(), rtol=0, atol=0)
        torch.testing.assert_close(w3t.float(), want3.to(dt).float(), rtol=0, atol=0)
        # the slope a one-element tensor of the net's slopes; t2 takes none
        assert act == "swish" and beta.shape == (1,) and float(beta) == float(d["betas"][0])
        assert act_t == "id" and beta_t is None


@pytest.mark.parametrize("c,mid,H,W,ok", [
    (3, 512, 32, 32, True), (12, 512, 16, 16, True), (48, 512, 8, 8, True),
    (49, 512, 8, 8, False),  # c over 48
    (12, 96, 16, 16, False),  # mid no multiple of 64
    (3, 512, 2, 32, False),  # H no multiple of the 4-row band at W 32
    (3, 512, 28, 28, False),  # W not 8, 16 or 32
])
def test_affine_route_shapes(c, mid, H, W, ok):
    for name in ("fp_conv_in", "rv_conv3x3_in"):
        check = lambda: fs.check_conv3x3_tc(name, c, mid, H, W, fs.conv3x3_in_rows(W))
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match=f"{name} on the tensor cores takes"):
                check()
