"""The final pair's backward C1^T products ``fp_conv_out`` (``p_a0 = C1^T
p_h1`` [, ``ra0 = C1^T rh1`` under preact]) of mode bf16 on the CPU. On the
card they run on the mid -> c tensor-core kernel
(``csrc/conv3x3_out_tc.cuh``, epilogue ``C3_FINAL``), which takes the mid
channels in chunks of 64 and, within a chunk, the 9 taps in order, each
(chunk, tap) K tile of 64 products into a fresh float32 partial added to the
sum, and reads W1T cast once per final-pair call into the Neumann chain's
tile layout, net n of the launch on the kernel of net n modulo the nets it
holds. ``ops/sum_order.py``'s ``fp_conv_out_tiled`` sums that way and stands
in for the kernel here; ``fp_conv_out_exact`` (the product summed in
float64, rounded once) reads the final pair's sum-order floor of
``chip_smoke.py`` phase 9.

* ``fp_conv_out_exact`` against float64 numpy, on two nets and on four
  "nets" of two nets' kernels: the float32 rounding of the float64 product
  (or a float32 beside it), nearly all to the bit.
* ``fp_conv_out_tiled`` sums in the kernel's order: on inputs built so that
  one output's (chunk, tap) partials are +2^24, +1 (the same chunk, the next
  tap) and -2^24 (the next chunk), that order reads 0, where the exact sum
  reads 1.
* The whole final pair with the tiled 5c (the plain pair otherwise) against
  the JAX package's ``fused_final_pair`` in interpret mode, preact on and
  off, at ``tests/test_torch_final_pair.py``'s bf16 tolerance (rel_norm
  2e-5 on T and every gradient) with its control (the pair in mode f32)
  above it.
* The four-net weight indexing: the backward launches ``fp_conv_out`` once
  under preact, on rh1 and p_h1 of both nets with the two nets' kernels
  (``nets=4``), which equals the product on both nets' kernels stacked
  twice, to the bit; W1T cast once per call into the tile layout in mode
  bf16 (mode f32 keeps OIHW float32).
* The shapes the route takes (``fused_solve.check_conv3x3_tc`` with the
  mid -> c kernel's band) and the nets it refuses.
"""
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_torch.ops import fused_chain as fc
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.implicit_grad import transpose_weights

from test_torch_backward_solve import rel_norm
from test_torch_final_pair import LABELS, NAMES, ROUNDED_TOL, UNROUNDED, _inputs, _jax
from test_torch_tc_chain_out import _order_case
from test_torch_tc_conv3x3_in import _bf16, _im2col64, _one_of

HS = 8
HW = HS * HS
NB = 2  # examples a net


def _operands(c, mid, nets, seed):
    """t (nets NB, mid, HW) of float32 values and W1T (2, c, mid, 3, 3) of
    bfloat16 values in the tile layout, with its OIHW form."""
    rng = np.random.RandomState(seed)
    t = torch.from_numpy(rng.standard_normal((nets * NB, mid, HW)).astype(np.float32))
    w1t = torch.from_numpy(_bf16(0.1 * rng.standard_normal((2, c, mid, 3, 3))))
    return t, fc.tile_w1t(w1t), w1t


def _out(fn, t, w, c, nets=None):
    out = torch.zeros(t.shape[0], c * HW)
    fn(t, w, "bf16", out, HS, HS, nets)
    return out


@pytest.mark.parametrize("nets", [2, 4])
def test_fp_conv_out_exact_is_the_float64_product(nets):
    c, mid = 12, 128
    t, w, w1t = _operands(c, mid, nets, 3 + nets)
    got = _out(so.fp_conv_out_exact, t, w, c, nets).numpy()
    cols = _im2col64(_bf16(t.numpy()).reshape(-1, mid, HS, HS))  # (nets NB, 9 mid, HW)
    wk = w1t.double().numpy().reshape(2, c, -1)
    p64 = np.stack([wk[(s // NB) % 2] @ cols[s] for s in range(nets * NB)])
    _one_of([got.reshape(p64.shape)], p64, lambda p: [p])


def test_fp_conv_out_tiled_sums_chunk_then_tap():
    t, w1t = _order_case()  # one net, c 1, mid 128
    w = fc.tile_w1t(w1t)
    at = lambda fn: float(_out(fn, t, w, 1)[0, 4 * HS + 4])
    assert at(so.fp_conv_out_tiled) == 0.0  # 2^24 + 1 rounds to 2^24 before the next chunk
    assert at(so.fp_conv_out_exact) == 1.0


def _port_pair(dx, dz, arrays, cot, mode, ops):
    """The port's (T_x, T_z) and gradients on ``ops``, in the order of
    ``tests/test_torch_final_pair.py``'s ``_jax``."""
    td = lambda d: {k: (torch.from_numpy(np.array(a)).requires_grad_(True)
                        if k != "preact" else a) for k, a in d.items()}
    dx, dz = td(dx), td(dz)
    x, z, ex, ez, ax, az = (torch.from_numpy(a) for a in arrays)
    x.requires_grad_(True)
    z.requires_grad_(True)
    T = ff._final_pair(ops, dx, dz, x, z, ex, ez, ax, az, mode)
    c = torch.from_numpy(cot)
    leaves = [x, z] + [dx[k] for k in NAMES] + [dz[k] for k in NAMES]
    grads = torch.autograd.grad((T[0] * c[0]).sum() + (T[1] * c[1]).sum(), leaves)
    return [t.detach() for t in T], list(grads)


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_final_pair_with_tiled_fp_conv_out_matches_jax(c, preact):
    dx, dz, arrays, cot = _inputs(c, preact)
    T_ref, g_ref = _jax(dx, dz, arrays, cot, "bf16")
    ops = dict(ff._PLAIN, fp_conv_out=so.fp_conv_out_tiled)
    T_got, g_got = _port_pair(dx, dz, arrays, cot, "bf16", ops)
    T_ctl, g_ctl = _port_pair(dx, dz, arrays, cot, "f32", ff._PLAIN)
    for name, g, r, k in zip(["T_x", "T_z"] + LABELS, T_got + g_got, T_ref + g_ref,
                             T_ctl + g_ctl):
        err = rel_norm(g.numpy(), r)
        assert err <= ROUNDED_TOL, (name, err)
        if name not in UNROUNDED:
            ctrl = rel_norm(k.numpy(), r)
            assert ctrl > ROUNDED_TOL, (name, ctrl)


def test_four_nets_index_the_two_nets_kernels():
    c, mid = 3, 64
    t, w, w1t = _operands(c, mid, 4, 11)
    four = _out(ff._fp_conv_out_plain, t, w, c, 4)
    stacked = _out(ff._fp_conv_out_plain, t, fc.tile_w1t(torch.cat([w1t] * 2)), c)
    assert torch.equal(four, stacked)
    # net n of the four takes kernel n % 2: slot s of net (s // NB) % 2
    for s in range(4 * NB):
        y = torch.nn.functional.conv2d(t[s].reshape(1, mid, HS, HS).bfloat16().float(),
                                       w1t[(s // NB) % 2], padding=1)
        torch.testing.assert_close(four[s], y.reshape(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_backward_casts_w1t_once_and_launches_four_nets(monkeypatch, mode, preact):
    dx, dz, arrays, cot = _inputs(3, preact)
    calls, tiles = [], []
    ops = dict(ff._PLAIN, fp_conv_out=lambda t, w, m, out, H, W, nets=None: (
        calls.append((t.shape[0], w, nets)), ff._fp_conv_out_plain(t, w, m, out, H, W, nets)))
    tile = ff.tile_w1t
    monkeypatch.setattr(ff, "tile_w1t", lambda w: tiles.append(w) or tile(w))
    _port_pair(dx, dz, arrays, cot, mode, ops)
    B = arrays[0].shape[0]
    assert len(calls) == 1
    rows, w, nets = calls[0]
    assert (rows, nets) == ((4 * B, 4) if preact else (2 * B, None))
    want = torch.stack([transpose_weights(*(torch.from_numpy(np.array(d[k])).float()
                                            for k in ("w1", "w2", "w3")))[2] for d in (dx, dz)])
    if mode == "bf16":
        assert len(tiles) == 2  # one cast in the forward, one in the backward call
        assert w.dtype == torch.bfloat16 and w.dim() == 4
        torch.testing.assert_close(fc.untile_w1t(w, 3, want.shape[2]),
                                   want.bfloat16().float(), rtol=0, atol=0)
    else:
        assert not tiles and w.dtype == torch.float32 and w.dim() == 5
        torch.testing.assert_close(w, want, rtol=0, atol=0)


@pytest.mark.parametrize("c,mid,H,W,ok", [
    (3, 512, 32, 32, True), (12, 512, 16, 16, True), (48, 512, 8, 8, True),
    (49, 512, 8, 8, False),  # c over 48
    (12, 96, 16, 16, False),  # mid no multiple of 64
    (3, 512, 4, 32, False),  # H no multiple of the 8-row band
    (3, 512, 28, 28, False),  # W not 8, 16 or 32
])
def test_fp_conv_out_route_shapes(c, mid, H, W, ok):
    check = lambda: fs.check_conv3x3_tc("fp_conv_out", c, mid, H, W, fs.C3_OUT_ROWS)
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="on the tensor cores takes"):
            check()


@pytest.mark.parametrize("nets,rows", [(3, 6), (4, 6)])
def test_fp_conv_out_refuses_nets_that_do_not_repeat_the_kernels(nets, rows):
    _, w, _ = _operands(3, 64, 1, 1)
    t = torch.zeros(rows, 64, HW)
    with pytest.raises(ValueError, match="nets|examples"):
        _out(ff._fp_conv_out_plain, t, w, 3, nets)
