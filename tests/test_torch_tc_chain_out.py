"""The Neumann chain's last J^T stage ``nc_jt_out_acc`` (``u = rnd(s0 * C1^T
t1)``, ``acc += c_k u``) in mode bf16 on the CPU. On the card it runs on the
mid -> c tensor-core kernel (``csrc/conv3x3_out_tc.cuh``, epilogue
``C3_CHAIN``), which takes the mid channels in chunks of 64 and, within a
chunk, the 9 taps in order, each (chunk, tap) K tile of 64 products into a
fresh float32 partial added to the sum, and reads W1T cast once per chain
call into its tile layout. ``ops/sum_order.py``'s ``nc_jt_out_acc_tiled``
sums that way and stands in for the kernel here; ``nc_jt_out_acc_exact``
(the product summed in float64, rounded once) reads the chain's sum-order
floor of ``chip_smoke.py`` phase 9.

* ``nc_jt_out_acc_exact`` against float64 numpy: u and acc are the
  epilogue of the float32 rounding of the float64 product (or of a float32
  beside it), nearly all to the bit, s0 bfloat16 or float32.
* ``nc_jt_out_acc_tiled`` sums in the kernel's order: on inputs built so
  that one output's (chunk, tap) partials are +2^24, +1 (the same chunk, the
  next tap) and -2^24 (the next chunk), that order reads 0, where the exact
  sum reads 1 and a tap-major order 1.
* The whole two-net chain with the tiled 2c, and with the tiled 2a and 2c
  together, against the JAX package's ``fused_neumann_chain2`` in interpret
  mode (c 3 and 12, mid 64, 8x8, batch 2, s bfloat16 or float32, n_power
  the cap 6), at ``tests/test_torch_neumann_chain.py``'s bf16 tolerance
  (rel_norm over acc - eps, 1e-4) with its control (the chain in float32)
  above it.
* W1T's tile layout (``fused_chain.tile_w1t``): bfloat16, exact, row tap *
  npad + co of each 64-channel chunk holding channels m0 .. m0 + 63 of
  ``w1t[co, :, ky, kx]``, zero rows past c, cast once per chain call by
  ``chain_operands`` in mode bf16 (mode f32 keeps OIHW float32), and
  unpacked exactly by the plain versions.
* The shapes the chain's route takes (``fused_solve.check_conv3x3_tc`` with
  the mid -> c kernel's band): the flagship's scales, and a refusal of the
  rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_chain as jfc
from implicit_normalizing_flows_torch.ops import fused_chain as fc
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.implicit_grad import transpose_weights

from test_torch_backward_solve import rel_norm
from test_torch_neumann_chain import BF16_TOL as CHAIN_TOL
from test_torch_neumann_chain import B, HW, jax_chain2, signed_coeffs, torch_chain
from test_torch_tc_conv3x3_in import _im2col64, _one_of

MID = 64  # one chunk of the mid -> c kernel
NETS = 2


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def make_chain(c, preact, seed, mid=MID):
    """(eps, s0, s1, s2, w1, w2, w3) numpy float32 of one net at ``mid``:
    ``tests/test_torch_neumann_chain.py``'s at mid 16, the kernels scaled by
    sqrt(16 / mid) so that J^T keeps its norm and the series converges."""
    rng = np.random.RandomState(seed)
    sig = lambda *s: 1.0 / (1.0 + np.exp(-rng.standard_normal(s)))
    eps = rng.choice([-1.0, 1.0], size=(B, c, HW, HW))
    s0 = sig(B, c, HW, HW) if preact else np.ones((B, c, HW, HW))
    s1, s2 = sig(B, mid, HW, HW), sig(B, mid, HW, HW)
    scale = np.sqrt(16.0 / mid)
    w1 = rng.standard_normal((mid, c, 3, 3)) * 0.2 * scale
    w2 = rng.standard_normal((mid, mid, 1, 1)) * 0.1 * scale
    w3 = rng.standard_normal((c, mid, 3, 3)) * 0.2 * scale
    return [a.astype(np.float32) for a in (eps, s0, s1, s2, w1, w2, w3)]


def _stage_operands(c, mid, s_bf16, seed):
    """t1 (NETS B, mid, HW HW) and W1T (NETS, c, mid, 3, 3) of bfloat16
    values, s0 (NETS B, c HW HW) bfloat16 or float32, acc, coefficients."""
    rng = np.random.RandomState(seed)
    t = torch.from_numpy(_bf16(rng.standard_normal((NETS * B, mid, HW * HW))))
    w1t = torch.from_numpy(_bf16(0.1 * rng.standard_normal((NETS, c, mid, 3, 3))))
    s0 = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal((NETS * B, c * HW * HW))))
                           ).astype(np.float32))
    s0 = s0.bfloat16() if s_bf16 else s0
    acc = torch.from_numpy(rng.standard_normal((NETS * B, c * HW * HW)).astype(np.float32))
    return t, w1t, s0, acc, torch.from_numpy(signed_coeffs())


def _stage(fn, t, w1t, s0, acc, coeffs, k=2):
    u, a = torch.zeros(t.shape[0], w1t.shape[1], HW, HW), acc.clone()
    fn(t, fc.tile_w1t(w1t), s0, "bf16", coeffs, k, u, a, HW, HW)
    return u, a


@pytest.mark.parametrize("s_bf16", [True, False])
def test_nc_jt_out_acc_exact_is_the_float64_product(s_bf16):
    c, mid, k = 12, 2 * MID, 2
    t, w1t, s0, acc, coeffs = _stage_operands(c, mid, s_bf16, 5)
    u, a = _stage(so.nc_jt_out_acc_exact, t, w1t, s0, acc, coeffs, k)
    cols = _im2col64(t.numpy().reshape(-1, mid, HW, HW))  # (NETS B, 9 mid, HW HW)
    wk = w1t.double().numpy().reshape(NETS, c, -1)
    p64 = np.stack([wk[s // B] @ cols[s] for s in range(NETS * B)]).reshape(NETS * B, -1)
    s0f, ck = s0.float().numpy(), float(coeffs[k])

    def epilogue(p):  # float32 ops, as the plain version takes them
        v = torch.from_numpy(p * s0f).bfloat16().float().numpy()
        return [v, acc.numpy() + np.float32(ck) * v]

    _one_of([u.numpy().reshape(NETS * B, -1), a.numpy()], p64, epilogue)


def _order_case():
    """One net, c 1, mid 128 (two chunks), 8x8: output (4, 4)'s (chunk, tap)
    partials are +2^24 (chunk 0, tap 0), +1 (chunk 0, tap 1) and -2^24
    (chunk 1, tap 0), every value bfloat16."""
    t = torch.zeros(1, 2 * MID, HW, HW)
    w1t = torch.zeros(1, 1, 2 * MID, 3, 3)
    t[0, 0, 3, 3], w1t[0, 0, 0, 0, 0] = 2.0**12, 2.0**12  # tap 0 reads (3, 3)
    t[0, 1, 3, 4], w1t[0, 0, 1, 0, 1] = 1.0, 1.0  # tap 1 reads (3, 4)
    t[0, MID, 3, 3], w1t[0, 0, MID, 0, 0] = 2.0**12, -(2.0**12)
    return t.reshape(1, 2 * MID, HW * HW), w1t


def test_nc_jt_out_acc_tiled_sums_chunk_then_tap():
    t, w1t = _order_case()
    s0, acc = torch.ones(1, HW * HW), torch.zeros(1, HW * HW)
    coeffs = torch.ones(1)
    tiled, _ = _stage(so.nc_jt_out_acc_tiled, t, w1t, s0, acc, coeffs, 0)
    exact, _ = _stage(so.nc_jt_out_acc_exact, t, w1t, s0, acc, coeffs, 0)
    assert float(tiled[0, 0, 4, 4]) == 0.0  # 2^24 + 1 rounds to 2^24 before the next chunk
    assert float(exact[0, 0, 4, 4]) == 1.0
    # a tap-major order (every chunk's tap 0 first) would cancel the 2^24s first
    wp = (w1t[0], None)
    v = t.reshape(1, 2 * MID, HW, HW)
    by_tap = sum(torch.nn.functional.conv2d(
        torch.nn.functional.pad(v, (1, 1, 1, 1))[:, :, d // 3:d // 3 + HW, d % 3:d % 3 + HW],
        wp[0][:, :, d // 3:d // 3 + 1, d % 3:d % 3 + 1]) for d in range(9))
    assert float(by_tap[0, 0, 4, 4]) == 1.0


def jax_chain2_s(cx, cz, n_power, s_bf16):
    """JAX's fused_neumann_chain2 in bfloat16 in interpret mode, its s
    factors in bfloat16 or float32 (the merged forward's)."""
    if s_bf16:
        return jax_chain2(cx, cz, n_power, jnp.bfloat16)
    c = cx[0].shape[1]
    c8 = max(8, -(-c // 8) * 8)

    def prep(ch):
        eps, w1, w2, w3 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (ch[0], *ch[4:]))
        s0, s1, s2 = (jnp.asarray(a, jnp.float32) for a in ch[1:4])
        pad = lambda a: jnp.pad(a, ((0, 0), (0, c8 - c), (0, 0), (0, 0)))
        flat = lambda a: a.reshape(B, a.shape[1], HW * HW)
        return (flat(pad(eps)), flat(pad(s0)), flat(s1), flat(s2),
                jfc.conv3_transpose_mats(w3, c8), jfc.conv1x1_transpose_mat(w2),
                jfc.conv3_transpose_mats_cout(w1, c8))

    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ax, az = jfc.fused_neumann_chain2(prep(cx), prep(cz), jnp.asarray(signed_coeffs()),
                                          jnp.asarray(n_power), H=HW, W=HW, interpret=True)
    unpad = lambda a: np.asarray(a)[:, :c].reshape(B, c, HW, HW)
    return unpad(ax), unpad(az)


def _port_chain(ch, s_bf16):
    """A chain tuple in bfloat16, its s factors float32 unless s_bf16."""
    out = list(torch_chain(ch, torch.bfloat16))
    if not s_bf16:
        out[1:4] = (torch.from_numpy(a) for a in ch[1:4])
    return tuple(out)


@pytest.mark.parametrize("stages", ["2c", "2a+2c"])
@pytest.mark.parametrize("s_bf16", [True, False])
@pytest.mark.parametrize("c", [3, 12])
def test_chain_with_tiled_nc_jt_out_acc_matches_jax(c, s_bf16, stages):
    n_power = len(signed_coeffs())
    cx, cz = make_chain(c, True, 21), make_chain(c, c == 3, 22)
    # the same bfloat16 values on both sides (the s factors float32 unless s_bf16)
    cx, cz = ([(t.float().numpy() if i not in (1, 2, 3) or s_bf16 else ch[i])
               for i, t in enumerate(torch_chain(ch, torch.bfloat16))] for ch in (cx, cz))
    ref = jax_chain2_s(cx, cz, n_power, s_bf16)
    coeffs = torch.from_numpy(signed_coeffs())
    ops = dict(fc._PLAIN, nc_jt_out_acc=so.nc_jt_out_acc_tiled)
    if stages == "2a+2c":
        ops["nc_jt_in"] = so.nc_jt_in_tiled
    got = fc._chain((_port_chain(cx, s_bf16), _port_chain(cz, s_bf16)), coeffs, n_power, ops)
    err = max(rel_norm(g.numpy(), r, e) for g, r, e in zip(got, ref, (cx[0], cz[0])))
    control = fc.fused_neumann_chain2_plain(torch_chain(cx, torch.float32),
                                            torch_chain(cz, torch.float32), coeffs, n_power)
    ctrl = min(rel_norm(a.numpy(), b, e) for a, b, e in zip(control, ref, (cx[0], cz[0])))
    assert err <= CHAIN_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("c,mid", [(3, 128), (12, 64), (48, 64), (5, 96)])
def test_tile_w1t_is_the_kernels_layout(c, mid):
    rng = np.random.RandomState(c)
    w1t = torch.from_numpy(_bf16(rng.standard_normal((NETS, c, mid, 3, 3))))
    tiles = fc.tile_w1t(w1t)
    npad, nch = fc.c3_out_npad(c), -(-mid // 64)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tuple(tiles.shape) == (NETS, nch, 9 * npad, 64)
    flat = tiles.float().numpy()
    w = w1t.numpy()
    for n in range(NETS):
        for q in range(nch):
            for d in range(9):
                rows = flat[n, q, d * npad:(d + 1) * npad]  # (npad, 64)
                for co in range(npad):
                    want = np.zeros(64, np.float32)
                    if co < c:
                        ch = w[n, co, q * 64:(q + 1) * 64, d // 3, d % 3]
                        want[:len(ch)] = ch
                    np.testing.assert_array_equal(rows[co], want)
    torch.testing.assert_close(fc.untile_w1t(tiles, c, mid), w1t, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_chain_operands_cast_w1t_once(monkeypatch, mode):
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    chains = [torch_chain(make_chain(12, True, s), dtype) for s in (1, 2)]
    calls = []
    tile = fc.tile_w1t
    monkeypatch.setattr(fc, "tile_w1t", lambda w: calls.append(w) or tile(w))
    seen = []
    ops = dict(fc._PLAIN, nc_jt_out_acc=lambda t, w1t, *a: seen.append(w1t)
               or fc._nc_jt_out_acc_plain(t, w1t, *a))
    fc._chain(chains, torch.from_numpy(signed_coeffs()), 3, ops)
    want = torch.stack([transpose_weights(*(w.float() for w in ch[4:7]))[2] for ch in chains])
    assert len(seen) == 3 and all(w is seen[0] for w in seen)  # one cast for every term
    if mode == "bf16":
        assert len(calls) == 1
        assert seen[0].dtype == torch.bfloat16 and seen[0].dim() == 4
        torch.testing.assert_close(fc.untile_w1t(seen[0], 12, MID), want, rtol=0, atol=0)
    else:
        assert not calls
        assert seen[0].dtype == torch.float32 and seen[0].dim() == 5
        torch.testing.assert_close(seen[0], want, rtol=0, atol=0)


@pytest.mark.parametrize("c,npad", [(1, 8), (3, 8), (8, 8), (9, 16), (12, 16), (16, 16),
                                    (17, 48), (48, 48), (50, 56)])
def test_c3_out_npad(c, npad):
    assert fc.c3_out_npad(c) == npad


@pytest.mark.parametrize("c,mid,H,W,ok", [
    (3, 512, 32, 32, True), (12, 512, 16, 16, True), (48, 512, 8, 8, True),
    (48, 192, 8, 8, True),
    (49, 512, 8, 8, False),  # c over 48
    (12, 96, 16, 16, False),  # mid no multiple of 64
    (3, 512, 4, 32, False),  # H no multiple of the 8-row band
    (3, 512, 28, 28, False),  # W not 8, 16 or 32
])
def test_chain_route_shapes(c, mid, H, W, ok):
    check = lambda: fs.check_conv3x3_tc("nc_jt_out_acc", c, mid, H, W, fs.C3_OUT_ROWS)
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="on the tensor cores takes"):
            check()
