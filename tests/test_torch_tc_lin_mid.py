"""The merged forward's 1x1 linearisation product in the split modes on the
CPU: ``lin_conv1x1_mid`` in ``tf32`` / ``tf32x`` writes swish(h2) and s2 =
swish'(h2) with h2 = W2 t1 + b2, and its kernel runs the bf16 split's 3 or
4 passes on the tensor cores (``csrc/mma_gemm.cuh``, ``EPI_SWISH_LIN``).
``ops/sum_order.py``'s ``lin_conv1x1_mid_tiled`` (summed in that kernel's
order: per K tile a fresh float32 partial of hi*hi and one of the small
passes) stands in for the kernel here, and ``lin_conv1x1_mid_exact`` (every
pass summed in float64, rounded once) reads the merged forward's sum-order
floor on the card (``chip_smoke.py`` phase 15).

* Each against the JAX package's ``_block_fwd_kernel``
  (``implicit_normalizing_flows_tpu/ops/fused_solve.py``) run by
  ``fused_block_forward`` in interpret mode, on a recipe-shaped block at
  idim 128 (two K tiles), 3x8x8, batch 2, with its ``_dswish`` wrapped to
  record, per example, net x's pre-activations h1 and h2 and its s2: the
  port's function runs on JAX's own t1 = swish(h1) with the net's W2 and
  b2, and its h2, swish(h2) and s2 are held to JAX's by ``chip_smoke.py``
  phase 2's measure (max error over the largest entry, at least 1) within
  1e-5, the limit of ``tests/test_torch_tc_split.py`` (the same exact
  products summed in another order).
* The whole merged forward with ``lin_conv1x1_mid_tiled`` (the plain
  forward otherwise) against JAX's ``fused_block_forward`` in interpret
  mode, at ``tests/test_torch_block_forward.py``'s tolerances: z and gx
  rtol 1e-4 / atol 1e-5, nstep within one, flags equal, the accs by
  rel_norm over acc - eps at 1e-4 with the f32 control above it.
* The forward hands ``lin_conv1x1_mid`` the solve's ``w2_mid``: W2's split
  as two bfloat16 halves, exactly, in the split modes (the tensor cores'
  operands), the float32 pair in modes f32 and bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from implicit_normalizing_flows_tpu.layers.implicit_block import ImplicitBlock as JBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_block as fb
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm
from test_torch_block_forward import BF16_TOL, KW, LADDER, N_POWER, make_blocks, signed
from test_torch_tc_split import TOL, rel_err

MID, HW_SIDE = 128, 8
HW = HW_SIDE * HW_SIDE
# the product of each function, for h2 = product + b2
PRODUCTS = {"exact": lambda x, wp, m: so._exact(x, wp, m, F.conv2d),
            "tiled": so._split_tiled}
FNS = {"exact": so.lin_conv1x1_mid_exact, "tiled": so.lin_conv1x1_mid_tiled}


@pytest.fixture(scope="module")
def wide_block():
    """A recipe-shaped JAX block at idim 128, 3x8x8, batch 2 (preact), its
    inputs, probes and both nets' conv_forward_data dicts, numpy."""
    def make_net():
        return build_conv_net((3, HW_SIDE, HW_SIDE), MID, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3,
                              3, "swish", preact=True, dropout=0.0, sn_atol=None,
                              sn_rtol=None, learn_p=False, first_resblock=False)

    block = JBlock(make_net(), make_net(), n_dist="poisson", n_exact_terms=2,
                   grad_in_forward=False)
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((2, 3, HW_SIDE, HW_SIDE)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    to_np = lambda d: {k: (np.asarray(a) if k != "preact" else a) for k, a in d.items()}
    probes = [rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32) for _ in range(2)]
    return (x, probes, to_np(block.nnet_x.conv_forward_data(sub("nnet_x"))),
            to_np(block.nnet_z.conv_forward_data(sub("nnet_z"))))


def _jax_block_forward(x, probes, dx, dz, mode, **extra):
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        return jfs.fused_block_forward(
            jnp.asarray(x), dx, dz, *(jnp.asarray(p) for p in probes), jnp.asarray(signed()),
            N_POWER, mode=mode, interpret=True, **dict(KW, **extra))


def _jax_lin(wide_block, mode):
    """(h1, h2, s2) of net x at x per example, (B, MID, HW), as
    ``_block_fwd_kernel`` makes them in ``mode``."""
    from jax.experimental import pallas as pl

    x, probes, dx, dz = wide_block
    calls, dswish = [], jfs._dswish

    def rec(t, b):  # _dswish, recording its (MID, HW) operands and results
        out = dswish(t, b)
        if t.shape == (MID, HW):
            jax.debug.callback(lambda i, a, o: calls.append((int(i), np.asarray(a),
                                                             np.asarray(o))),
                               pl.program_id(0), t, out)
        return out

    jfs._dswish = rec
    try:
        _jax_block_forward(x, probes, dx, dz, mode, threshold=2)
    finally:
        jfs._dswish = dswish
    out = []
    for b in range(x.shape[0]):
        mine = [(a, o) for i, a, o in calls if i == b]
        assert len(mine) == 4  # s1x, s2x, s1z, s2z
        out.append((mine[0][0], mine[1][0], mine[1][1]))
    return tuple(np.stack(a) for a in zip(*out))


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_lin_conv1x1_mid_matches_jax(wide_block, mode, fn):
    _, _, dx, _ = wide_block
    h1, h2, s2 = _jax_lin(wide_block, mode)
    b1, b2, beta2 = (float(dx["betas"][1]), torch.from_numpy(dx["b2"]),
                     float(dx["betas"][2]))
    t1 = np.asarray(jfs._swish(jnp.asarray(h1), jnp.float32(b1)))
    B = t1.shape[0]
    wp = fs.prep_conv1x1_mid(fs.prep_weight(torch.from_numpy(dx["w2"]), mode), mode)
    out, s2k = torch.zeros(B, MID, HW), torch.zeros(B, MID, HW)
    tt = torch.from_numpy(t1)
    FNS[fn](tt, wp, b2, beta2, mode, out, s2k, HW_SIDE, HW_SIDE)
    h2k = PRODUCTS[fn](tt.reshape(B, MID, HW_SIDE, HW_SIDE), tuple(wp), mode) \
        + b2[None, :, None, None]
    swish_h2 = np.asarray(jfs._swish(jnp.asarray(h2), jnp.float32(beta2)))
    errs = {"h2": rel_err(h2k.reshape(B, MID, HW), h2), "swish(h2)": rel_err(out, swish_h2),
            "s2": rel_err(s2k, s2)}
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("mode,ladder", [("tf32", True), ("tf32x", False)])
@pytest.mark.parametrize("preact", [True, False])
def test_block_forward_with_tiled_lin_matches_jax(preact, mode, ladder):
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
    ops = dict(fb._PLAIN_OPS, lin_conv1x1_mid=so.lin_conv1x1_mid_tiled)
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
    assert err <= BF16_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("mode", ["tf32", "tf32x", "f32", "bf16"])
def test_lin_conv1x1_mid_gets_w2_mid(mode):
    _, _, block, x, probes = make_blocks(True)
    data = lambda net: {k: (a.detach() if torch.is_tensor(a) else a)
                        for k, a in getattr(block, net).conv_forward_data().items()}
    seen = []

    def rec(t1, wp, *a):
        seen.append(wp)
        return fb._lin_conv1x1_mid_plain(t1, wp, *a)

    ops = dict(fb._PLAIN_OPS, lin_conv1x1_mid=rec)
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)
    dx, dz = data("nnet_x"), data("nnet_z")
    fs._solve(torch.from_numpy(x), dx, dz, ops, linearise=True,
              **dict(full, **KW), mode=mode)
    assert len(seen) == 2  # net x at x, net z at the best iterate
    for wp, d in zip(seen, (dx, dz)):
        pair = fs.prep_weight(d["w2"], mode)
        if mode in fs.SPLIT_MODES:
            for half, want in zip(wp, pair):
                assert half.dtype == torch.bfloat16 and half.is_contiguous()
                torch.testing.assert_close(half.float(), want, rtol=0, atol=0)
        else:
            assert wp[0].dtype == torch.float32
            torch.testing.assert_close(wp[0], pair[0], rtol=0, atol=0)
