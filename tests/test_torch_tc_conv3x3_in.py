"""The c -> mid 3x3 products of the Neumann chain (``nc_jt_in``, mode bf16)
and of the merged forward's linearisation (``lin_conv3x3_in``, modes
``tf32`` / ``tf32x``) on the CPU. Both run on one tensor-core kernel on the
card (``csrc/conv3x3_in_tc.cuh``), which sums the im2col's k = ci * 9 + ky *
3 + kx in K tiles of 16, each into a fresh float32 partial (in the split
modes one of hi*hi and one of the small passes). ``ops/sum_order.py``'s
``*_tiled`` functions sum that way and stand in for the kernel here; its
``*_exact`` functions (the product summed in float64, rounded once) read
the sum-order floors of ``chip_smoke.py`` phases 9 and 15.

* ``nc_jt_in_exact`` / ``_tiled`` against the first J^T stage ``rnd(dot(m3,
  u9) * s2)`` of the JAX package's ``_make_apply_jt``
  (``implicit_normalizing_flows_tpu/ops/fused_chain.py``), run inside a
  ``pallas_call`` in interpret mode with ``jax.lax.dot_general`` wrapped to
  record the next stage's input: two nets, c 3, 12 and 48 (K 27, 108, 432),
  mid 32, 8x8, s2 bfloat16 or float32. By rel_norm at 2e-4 (``chip_smoke.py``'s
  ``ROUNDED_TOL``: both round the output to bfloat16, so an output one
  float32 ulp apart moves at a tie); the control, the plain version in mode
  f32 (no rounding), must read above it.
* The whole two-net chain with ``nc_jt_in_tiled`` (the plain chain
  otherwise) against JAX's ``fused_neumann_chain2`` in interpret mode, at
  ``tests/test_torch_neumann_chain.py``'s bf16 tolerance with its control.
* ``lin_conv3x3_in_exact`` / ``_tiled`` against h1, swish(h1), s1 and s0
  recorded from ``_block_fwd_kernel`` inside JAX's ``fused_block_forward``
  in interpret mode (a ``jax.debug.callback`` in a wrapped ``_dswish``) on a
  recipe-shaped block at idim 128, 3x8x8, preact on and off, by
  ``chip_smoke.py``'s ``SPLIT_TOL`` (max error over the largest entry, at
  least 1); on the precision probe (``ops/precision_probe.py``) the tiled
  product lies within it of the plain version of its mode, and the controls
  (plain f32 and native TF32 against tf32, plain tf32 against tf32x) above.
* The whole merged forward with ``lin_conv3x3_in_tiled`` against JAX's, at
  ``tests/test_torch_block_forward.py``'s tolerances.
* The exact products against float64 numpy: every output one of the
  epilogue's values at the float32 rounding of the float64 product or one
  ulp beside it, nearly all to the bit.
* The kernels' weights: W3T cast once per step to bfloat16 in mode bf16
  (``chain_operands``) and W1's split cast once per solve to bfloat16
  halves in the split modes, both exactly.
* The shapes the 3x3 tensor-core kernels take (``fused_solve
  .check_conv3x3_tc``, shared by both directions): mid any multiple of 64,
  and a refusal, never a fallback, of the rest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from implicit_normalizing_flows_tpu.layers.implicit_block import ImplicitBlock as JBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_chain as jfc
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_block as fb
from implicit_normalizing_flows_torch.ops import fused_chain as fc
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.implicit_grad import transpose_weights
from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32, tf32_probe

from test_torch_backward_solve import rel_norm
from test_torch_block_forward import KW, LADDER, N_POWER, make_blocks, signed
from test_torch_block_forward import BF16_TOL as BLOCK_TOL
from test_torch_neumann_chain import BF16_TOL as CHAIN_TOL
from test_torch_neumann_chain import jax_chain2, make_chain, signed_coeffs, torch_chain
from test_torch_tc_split import rel_err

ROUNDED_TOL = 2e-4  # chip_smoke.py phase 8's limit for the chain's rounded stages
SPLIT_TOL = 1e-4    # chip_smoke.py phases 2 / 14's limit for the split modes
NETS, NB, MID_C, HS = 2, 2, 32, 8
HW = HS * HS
MID = 128  # the linearisation's idim
NC_FNS = {"exact": so.nc_jt_in_exact, "tiled": so.nc_jt_in_tiled}
LIN_FNS = {"exact": so.lin_conv3x3_in_exact, "tiled": so.lin_conv3x3_in_tiled}
LIN_PRODUCTS = {"exact": so._conv3x3_in_exact, "tiled": so._conv3x3_in_tiled}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@functools.lru_cache(maxsize=None)
def _chain_case(c, s_bf16):
    """Two nets' first J^T stage at c: (u (NETS NB, c, HS, HS), w3 (NETS, c,
    MID_C, 3, 3), s2 (NETS NB, MID_C, HW)) numpy of bfloat16 values (s2
    float32 ones unless s_bf16), and JAX's t2 (NETS NB, MID_C, HW)."""
    from jax.experimental import pallas as pl

    rng = np.random.RandomState(c + 100 * s_bf16)
    u = _bf16(rng.standard_normal((NETS * NB, c, HS, HS)))
    w3 = _bf16(0.2 * rng.standard_normal((NETS, c, MID_C, 3, 3)))
    s2 = (1.0 / (1.0 + np.exp(-rng.standard_normal((NETS * NB, MID_C, HW))))).astype(np.float32)
    if s_bf16:
        s2 = _bf16(s2)
    c8 = max(8, -(-c // 8) * 8)
    bf, f32 = jnp.bfloat16, jnp.float32

    def kernel(u_ref, s2_ref, m3_ref, m2_ref, m1_ref, t_ref, u9_ref):
        seen, dot = {}, jax.lax.dot_general

        def rec(a, b, *args, **kw):  # the second stage's dot records its input
            if a.shape == (MID_C, MID_C):
                seen["t"] = b
            return dot(a, b, *args, **kw)

        jax.lax.dot_general = rec
        try:
            jt = jfc._make_apply_jt(jfc._make_shifted(HS, HS, 1), jnp.ones((c8, HW), f32),
                                    jnp.ones((MID_C, HW), f32), s2_ref[:], m3_ref, m2_ref,
                                    m1_ref, u9_ref, c8, MID_C, HW, bf)
            jt(u_ref[:])
        finally:
            jax.lax.dot_general = dot
        t_ref[:] = seen["t"].astype(f32)

    call = pl.pallas_call(kernel, out_shape=[jax.ShapeDtypeStruct((MID_C, HW), f32),
                                             jax.ShapeDtypeStruct((9 * c8, HW), bf)],
                          interpret=True)
    m2, m1 = jnp.zeros((MID_C, MID_C), bf), jnp.zeros((9 * c8, MID_C), bf)
    t2 = []
    for s in range(NETS * NB):
        m3 = jfc.conv3_transpose_mats(jnp.asarray(w3[s // NB], bf), c8)
        us = jnp.pad(jnp.asarray(u[s], bf), ((0, c8 - c), (0, 0), (0, 0))).reshape(c8, HW)
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            t, _ = call(us, jnp.asarray(s2[s]).astype(bf if s_bf16 else f32), m3, m2, m1)
        t2.append(np.asarray(t))
    return u, w3, s2, np.stack(t2)


def _chain_operands(u, w3, s2, s_bf16):
    """(U, W3T, S2) as chain_operands makes them in mode bf16."""
    w3t = torch.stack([transpose_weights(*(torch.from_numpy(w),) * 3)[0]
                       for w in w3]).to(torch.bfloat16)
    S2 = torch.from_numpy(s2).to(torch.bfloat16 if s_bf16 else torch.float32)
    return torch.from_numpy(u), w3t.contiguous(), S2


def _nc(fn, U, W3T, S2, mode):
    out = torch.zeros(U.shape[0], MID_C, HW)
    fn(U, W3T, S2, mode, out)
    return out


@pytest.mark.parametrize("s_bf16", [True, False])
@pytest.mark.parametrize("c", [3, 12, 48])
def test_nc_jt_in_matches_jax(c, s_bf16):
    u, w3, s2, ref = _chain_case(c, s_bf16)
    U, W3T, S2 = _chain_operands(u, w3, s2, s_bf16)
    errs = {name: rel_norm(_nc(fn, U, W3T, S2, "bf16").numpy(), ref)
            for name, fn in NC_FNS.items()}
    ctrl = rel_norm(_nc(fc._nc_jt_in_plain, U, W3T.float(), S2, "f32").numpy(), ref)
    assert max(errs.values()) <= ROUNDED_TOL < ctrl, (errs, ctrl)


@pytest.mark.parametrize("c,preact", [(3, True), (12, False)])
def test_chain_with_tiled_nc_jt_in_matches_jax(c, preact):
    n_power = len(signed_coeffs())
    cx, cz = make_chain(c, preact, 11), make_chain(c, preact, 12)
    cx, cz = ([t.float().numpy() for t in torch_chain(ch, torch.bfloat16)] for ch in (cx, cz))
    ref = jax_chain2(cx, cz, n_power, jnp.bfloat16)
    coeffs = torch.from_numpy(signed_coeffs())
    ops = dict(fc._PLAIN, nc_jt_in=so.nc_jt_in_tiled)
    got = fc._chain((torch_chain(cx, torch.bfloat16), torch_chain(cz, torch.bfloat16)), coeffs,
                    n_power, ops)
    err = max(rel_norm(g.numpy(), r, e) for g, r, e in zip(got, ref, (cx[0], cz[0])))
    control = fc.fused_neumann_chain2_plain(torch_chain(cx, torch.float32),
                                            torch_chain(cz, torch.float32), coeffs, n_power)
    ctrl = min(rel_norm(a.numpy(), b, e) for a, b, e in zip(control, ref, (cx[0], cz[0])))
    assert err <= CHAIN_TOL < ctrl, (err, ctrl)


@functools.lru_cache(maxsize=None)
def _wide_block(preact):
    """A recipe-shaped JAX block at idim 128, 3x8x8, batch 2 (preact on, or
    off as a scale's first block), its inputs, probes and both nets'
    conv_forward_data dicts, numpy."""
    def make_net():
        return build_conv_net((3, HS, HS), MID, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3, 3, "swish",
                              preact=preact, dropout=0.0, sn_atol=None, sn_rtol=None,
                              learn_p=False, first_resblock=not preact)

    block = JBlock(make_net(), make_net(), n_dist="poisson", n_exact_terms=2,
                   grad_in_forward=False)
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((2, 3, HS, HS)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(4), jnp.asarray(x))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    to_np = lambda d: {k: (np.array(a) if k != "preact" else a) for k, a in d.items()}
    probes = [rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32) for _ in range(2)]
    return (x, probes, to_np(block.nnet_x.conv_forward_data(sub("nnet_x"))),
            to_np(block.nnet_z.conv_forward_data(sub("nnet_z"))))


def _jax_block_forward(x, probes, dx, dz, mode, **extra):
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        return jfs.fused_block_forward(
            jnp.asarray(x), dx, dz, *(jnp.asarray(p) for p in probes), jnp.asarray(signed()),
            N_POWER, mode=mode, interpret=True, **dict(KW, **extra))


@functools.lru_cache(maxsize=None)
def _jax_lin(preact, mode):
    """(h1, s1 (B, MID, HW)[, s0 (B, c, HW)]) of net x at x per example, as
    ``_block_fwd_kernel`` makes them in ``mode``."""
    from jax.experimental import pallas as pl

    x, probes, dx, dz = _wide_block(preact)
    calls, dswish = [], jfs._dswish

    def rec(t, b):  # _dswish, recording its operands and results
        out = dswish(t, b)
        jax.debug.callback(lambda i, a, o: calls.append((int(i), np.asarray(a), np.asarray(o))),
                           pl.program_id(0), t, out)
        return out

    jfs._dswish = rec
    try:
        _jax_block_forward(x, probes, dx, dz, mode, threshold=2)
    finally:
        jfs._dswish = dswish
    h1, s1, s0 = [], [], []
    for b in range(x.shape[0]):
        mid = [(a, o) for i, a, o in calls if i == b and a.shape == (MID, HW)]
        small = [(a, o) for i, a, o in calls if i == b and a.shape != (MID, HW)]
        assert len(mid) == 4 and len(small) == (2 if preact else 0)  # net x's first
        h1.append(mid[0][0])
        s1.append(mid[0][1])
        if preact:
            s0.append(small[0][1][:x.shape[1]])
    return np.stack(h1), np.stack(s1), (np.stack(s0) if preact else None)


def _lin(fn, x, wp, dx, preact, mode):
    """fn (a lin_conv3x3_in version) on x: (out, s1, s0)."""
    B, c = x.shape[:2]
    outs = (torch.zeros(B, MID, HW), torch.zeros(B, MID, HW), torch.zeros(B, c * HW))
    fn(torch.from_numpy(x), wp, torch.from_numpy(dx["b1"]), [float(v) for v in dx["betas"]],
       preact, mode, *outs)
    return outs


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_lin_conv3x3_in_matches_jax(mode, preact):
    x, _, dx, _ = _wide_block(preact)
    h1, s1, s0 = _jax_lin(preact, mode)
    betas = [float(v) for v in dx["betas"]]
    wp = fs.prep_conv1x1_mid(fs.prep_weight(torch.from_numpy(dx["w1"]), mode), mode)
    xin = torch.from_numpy(x)
    if preact:
        xin = fs.swish(xin, betas[0])
    B = x.shape[0]
    for name, fn in LIN_FNS.items():
        out, s1k, s0k = _lin(fn, x, wp, dx, preact, mode)
        h1k = LIN_PRODUCTS[name](xin, wp, mode) + torch.from_numpy(dx["b1"])[None, :, None, None]
        swish_h1 = np.asarray(jfs._swish(jnp.asarray(h1), jnp.float32(betas[1])))
        errs = {"h1": rel_err(h1k.reshape(B, MID, HW), h1), "swish(h1)": rel_err(out, swish_h1),
                "s1": rel_err(s1k, s1)}
        if preact:
            errs["s0"] = rel_err(s0k.reshape(s0.shape), s0)
        assert max(errs.values()) <= SPLIT_TOL, (name, errs)


@pytest.mark.parametrize("c", [3, 12])
def test_lin_conv3x3_in_tiled_probe_controls(c):
    """On the precision probe the tiled product (the kernel's order) lies
    within SPLIT_TOL of the plain version of its mode, and the controls lie
    above it: plain f32 and native TF32 against tf32, plain tf32 against
    tf32x."""
    x, w = (torch.from_numpy(a) for a in tf32_probe(2, c, MID, HS, HS, 3, 10 + c))
    zero = torch.zeros(MID)

    def run(fn, mode, xx, ww):
        wp = fs.prep_weight(ww, mode)
        if fn is not fb._lin_conv3x3_in_plain:
            wp = fs.prep_conv1x1_mid(wp, mode)
        outs = (torch.zeros(2, MID, HW), torch.zeros(2, MID, HW))
        fn(xx, wp, zero, [1.0] * 3, False, mode, *outs, None)
        return outs

    plain = lambda m, xx=x, ww=w: run(fb._lin_conv3x3_in_plain, m, xx, ww)
    read = lambda a, b: max(rel_err(p, q) for p, q in zip(a, b))
    tf32, tf32x = (run(so.lin_conv3x3_in_tiled, m, x, w) for m in ("tf32", "tf32x"))
    assert read(tf32, plain("tf32")) <= SPLIT_TOL < min(
        read(tf32, plain("f32")), read(tf32, plain("f32", round_tf32(x), round_tf32(w))))
    assert read(tf32x, plain("tf32x")) <= SPLIT_TOL < read(tf32x, plain("tf32"))


@pytest.mark.parametrize("mode,ladder,preact", [("tf32", True, True), ("tf32x", False, False)])
def test_block_forward_with_tiled_lin_conv3x3_in_matches_jax(mode, ladder, preact):
    jblock, v, block, x, probes = make_blocks(preact)
    extra = LADDER if ladder else {}
    data = lambda net: {k: (a.detach() if torch.is_tensor(a) else a)
                        for k, a in getattr(block, net).conv_forward_data().items()}
    jdata = lambda net: getattr(jblock, net).conv_forward_data(
        {"params": v["params"][net], "state": v["state"][net]})
    ref, rax, raz = _jax_block_forward(x, probes, jdata("nnet_x"), jdata("nnet_z"), mode,
                                       **extra)
    args = (torch.from_numpy(x), data("nnet_x"), data("nnet_z"),
            *(torch.from_numpy(p) for p in probes), torch.from_numpy(signed()), N_POWER)
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)
    ops = dict(fb._PLAIN_OPS, lin_conv3x3_in=so.lin_conv3x3_in_tiled)
    got, gax, gaz = fb._block_forward(ops, *args, **dict(full, **KW, **extra), mode=mode)
    for g, r in ((got.result, ref.result), (got.gx, ref.gx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.prot_break.numpy(), np.asarray(ref.prot_break))
    assert (np.abs(got.nstep.numpy() - np.asarray(ref.nstep)) <= 1).all()
    accs = list(zip((gax, gaz), (rax, raz), probes))
    err = max(rel_norm(g.numpy(), np.asarray(r), e) for g, r, e in accs)
    _, cax, caz = fb.fused_block_forward_plain(*args, mode="f32", **KW)
    ctrl = min(rel_norm(cc.numpy(), np.asarray(r), e) for cc, (_, r, e) in zip((cax, caz), accs))
    assert err <= BLOCK_TOL < ctrl, (err, ctrl)


def _im2col64(x):
    """(B, c, H, W) -> (B, 9 c, H W) float64, k = ci * 9 + ky * 3 + kx."""
    B, c, H, W = x.shape
    xp = np.pad(np.asarray(x, np.float64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    cols = [xp[:, :, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)]
    return np.stack(cols, 2).reshape(B, 9 * c, H * W)


def _one_of(got, p64, epilogue):
    """got is the epilogue of the float32 rounding of the float64 product
    or of a float32 beside it, nearly everywhere the rounding itself."""
    p32 = p64.astype(np.float32)
    cands = [epilogue(q) for q in (np.nextafter(p32, np.float32(-np.inf)), p32,
                                   np.nextafter(p32, np.float32(np.inf)))]
    for g, cand in zip(got, zip(*cands)):
        assert np.all(np.any([g == c for c in cand], axis=0))
        assert np.mean(g == cand[1]) > 0.99


def test_nc_jt_in_exact_is_the_float64_product():
    u, w3, s2, _ = _chain_case(48, True)
    U, W3T, S2 = _chain_operands(u, w3, s2, True)
    got = _nc(so.nc_jt_in_exact, U, W3T, S2, "bf16").numpy()
    cols = _im2col64(u)
    wk = W3T.double().numpy().reshape(NETS, MID_C, -1)
    p64 = np.stack([wk[s // NB] @ cols[s] for s in range(NETS * NB)])
    rnd = lambda p: torch.from_numpy(p * s2).bfloat16().float().numpy()  # float32 ops
    _one_of([got], p64, lambda p: [rnd(p)])


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_lin_conv3x3_in_exact_is_the_float64_product(mode):
    x, _, dx, _ = _wide_block(True)
    rng = np.random.RandomState(7)
    x = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    betas = [float(v) for v in dx["betas"]]
    wp = fs.prep_weight(torch.from_numpy(dx["w1"]), mode)
    out, s1, _ = _lin(so.lin_conv3x3_in_exact, x, fs.prep_conv1x1_mid(wp, mode), dx, True,
                      mode)
    xs = fs.swish(torch.from_numpy(x), betas[0]).numpy()
    xh = _bf16(xs)
    xl = _bf16(xs - xh)
    wh, wl = (w.double().numpy().reshape(MID, -1) for w in wp)
    ch, cl = _im2col64(xh), _im2col64(xl)
    p64 = (np.einsum("mk,bkp->bmp", wh, ch) + np.einsum("mk,bkp->bmp", wh, cl)
           + np.einsum("mk,bkp->bmp", wl, ch)
           + (np.einsum("mk,bkp->bmp", wl, cl) if mode == "tf32x" else 0.0))
    b1 = torch.from_numpy(dx["b1"])[None, :, None]

    def epilogue(p):
        h1 = torch.from_numpy(p) + b1
        return [fs.swish(h1, betas[1]).numpy(), fs.dswish(h1, betas[1]).numpy()]

    _one_of([out.numpy(), s1.numpy()], p64, epilogue)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_chain_operands_cast_w3t_once_exactly(mode):
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    chains = [torch_chain(make_chain(12, True, s), dtype) for s in (1, 2)]
    op = fc.chain_operands(chains, torch.from_numpy(signed_coeffs()))
    want = torch.stack([transpose_weights(*(w.float() for w in ch[4:7]))[0] for ch in chains])
    assert op["W3T"].dtype == fc.mid_weight_dtype(mode) and op["W3T"].is_contiguous()
    torch.testing.assert_close(op["W3T"].float(), want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["tf32", "tf32x", "f32", "bf16"])
def test_lin_conv3x3_in_gets_w1_cast_once(mode):
    _, _, block, x, _ = make_blocks(True)
    data = lambda net: {k: (a.detach() if torch.is_tensor(a) else a)
                        for k, a in getattr(block, net).conv_forward_data().items()}
    seen = []

    def rec(inp, wp, *a):
        seen.append(wp)
        return fb._lin_conv3x3_in_plain(inp, wp, *a)

    ops = dict(fb._PLAIN_OPS, lin_conv3x3_in=rec)
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)
    dx, dz = data("nnet_x"), data("nnet_z")
    fs._solve(torch.from_numpy(x), dx, dz, ops, linearise=True, **dict(full, **KW), mode=mode)
    assert len(seen) == 2  # net x at x, net z at the best iterate
    for wp, d in zip(seen, (dx, dz)):
        pair = fs.prep_weight(d["w1"], mode)
        if mode in fs.SPLIT_MODES:
            for half, want in zip(wp, pair):
                assert half.dtype == torch.bfloat16 and half.is_contiguous()
                assert half.shape == d["w1"].shape
                torch.testing.assert_close(half.float(), want, rtol=0, atol=0)
        else:
            assert wp[0].dtype == torch.float32
            torch.testing.assert_close(wp[0], pair[0], rtol=0, atol=0)


# (c, mid, H, W): the recipe's scales at mid 512, and mids that are no
# multiple of the c -> mid kernel's 128-row chunk at 8x8 or split unevenly
# over its groups of blocks
@pytest.mark.parametrize("c,mid,H,W", [(3, 512, 32, 32), (12, 384, 16, 16), (48, 192, 8, 8),
                                       (48, 64, 8, 8), (3, 64, 4, 32)])
def test_check_conv3x3_tc_takes_mid_multiples_of_64(c, mid, H, W):
    fs.check_conv3x3_tc("nc_jt_in", c, mid, H, W, fs.conv3x3_in_rows(W))


@pytest.mark.parametrize("c,mid,H,W,rows", [
    (49, 512, 8, 8, 8),  # c over 48
    (3, 96, 32, 32, 4),  # mid no multiple of 64
    (3, 512, 12, 12, 8),  # W not 8, 16 or 32
    (12, 512, 12, 16, 8),  # H not a multiple of the c -> mid kernel's band
    (3, 512, 4, 32, fs.C3_OUT_ROWS),  # nor of the mid -> c kernel's
])
def test_check_conv3x3_tc_refuses(c, mid, H, W, rows):
    with pytest.raises(ValueError, match="on the tensor cores takes"):
        fs.check_conv3x3_tc("k", c, mid, H, W, rows)


def test_check_conv3x3_tc_refuses_misaligned():
    out = torch.zeros(5)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fs.check_conv3x3_tc("k", 3, 512, 32, 32, fs.conv3x3_in_rows(32), out=out)
