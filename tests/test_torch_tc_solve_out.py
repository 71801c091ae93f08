"""The forward solve's mid -> c 3x3 product ``conv3x3_out`` (``conv3x3 mid
-> c + b3`` fused with the residual ``base + sgn * y [- sub]``, on an active
list) in the split modes on the CPU. On the card it runs on the mid -> c
tensor-core kernel (``csrc/conv3x3_out_tc.cuh``, epilogue ``C3_SOLVE``),
which splits t2 into hi / lo halo tiles as it loads them, takes W3's halves
cast once per solve into the tile layout (``prep_weights``' ``w3_tc``), and
sums per (chunk of 64 mid channels, tap) a fresh float32 partial of hi*hi
and one of the small passes. ``ops/sum_order.py``'s ``conv3x3_out_tiled``
sums that way and stands in for the kernel here; ``conv3x3_out_exact``
(every pass summed in float64, rounded once) reads the solve's sum-order
floor of ``chip_smoke.py`` phase 3.

* The plain, exact and tiled products against the conv3 stage of the JAX
  package's ``_make_eval`` (``R = d3(t)``, the taps' shifted sum and ``+
  b3``), run inside a ``pallas_call`` in interpret mode on a recipe-shaped
  block at idim 128, 3x8x8: net x at x (``x_embed = x + y``) and net z at
  z0 = x (``x_embed - y - z0``), tf32 and tf32x, on the whole list and on a
  partial permuted one (slot s reads t2[s] and writes example idx[s]; the
  other examples' rows stay bitwise as they were), by ``chip_smoke.py``'s
  ``SPLIT_TOL`` (max error over the largest entry, at least 1).
* ``conv3x3_out_exact`` against the float64 product of the split (numpy):
  the epilogue of its float32 rounding or of a float32 beside it.
* ``conv3x3_out_tiled`` sums in the kernel's order: on inputs built so that
  the second chunk's tap 7 holds {-2^25, +1}, that order reads 0 where the
  exact sum and a k-ordered float32 sum read 1.
* On the precision probe (``ops/precision_probe.py``) the tiled product
  lies within SPLIT_TOL of the plain version of its mode, and the controls
  (plain f32 and native TF32 against tf32, plain tf32 against tf32x) above.
* The whole forward solve with the tiled 1c (and with 1a, 1b and 1c tiled
  together) against JAX's ``fused_broyden_solve`` in interpret mode, at
  ``tests/test_torch_fused_solve.py``'s tolerances.
* W3's halves in the tile layout (``w3_tc``): bfloat16, exact, row tap *
  npad + co of each 64-channel chunk, back to OIHW equal to
  ``prep_weight``'s pair; cast once per solve and mode; modes f32 / bf16
  keep the float32 pair (the CUDA cores).
* The split form's shared memory, ``conv3x3_out_smem``, is the kernel's
  ``c3_smem_bytes(TW, NT, 2, 2)``: every width and c the kernel takes fits
  an SM's, and ``check_conv3x3_tc`` refuses tiles past it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_chain as jfc
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32, tf32_probe

from test_torch_fused_solve import KW, _assert_match, _torch
from test_torch_tc_conv3x3_in import HS, HW, MID, _bf16, _im2col64, _one_of, _wide_block
from test_torch_tc_split import rel_err

SPLIT_TOL = 1e-4  # chip_smoke.py phase 2's limit for the split modes
OUT_FNS = {"plain": fs._conv3x3_out_plain, "exact": so.conv3x3_out_exact,
           "tiled": so.conv3x3_out_tiled}
SENTINEL = -7.25


@functools.lru_cache(maxsize=None)
def _jax_conv3(mode):
    """(x (B, c, HS, HS), [(t, y) of net x at x, (t, y) of net z at x]) with
    t (B, MID, HW) the conv3 stage's input swish(h2) and y (B, c, HW) its
    output, from ``_make_eval`` inside a ``pallas_call`` in interpret mode,
    on the same matrices as the JAX solve's (``_prep_fwd``)."""
    from jax.experimental import pallas as pl

    x, _, dx, dz = _wide_block(True)
    B, c = x.shape[:2]
    c8 = max(8, -(-c // 8) * 8)
    f32 = jnp.float32
    out = []
    for d in (dx, dz):
        mats = jfs._prep_fwd({k: jnp.asarray(v) for k, v in d.items() if k != "preact"}, c8)
        betas = [float(v) for v in d["betas"]]

        def kernel(h_ref, m1, m2, m3, b1, b2, b3, y_ref, t_ref):
            ev = jfs._make_eval(jfc._make_shifted(HS, HS, 1), mode, m1[:], m2[:], m3[:], b1[:],
                                b2[:], b3[:], betas[0], betas[1], betas[2], bool(d["preact"]),
                                c8, HW, want_aux=True)
            y, (_, h2) = ev(h_ref[:])
            y_ref[:] = y
            t_ref[:] = jfs._swish(h2, f32(betas[2]))

        call = pl.pallas_call(kernel, out_shape=[jax.ShapeDtypeStruct((c8, HW), f32),
                                                 jax.ShapeDtypeStruct((MID, HW), f32)],
                              interpret=True)
        ts, ys = [], []
        for b in range(B):
            h = jnp.pad(jnp.asarray(x[b]), ((0, c8 - c), (0, 0), (0, 0))).reshape(c8, HW)
            with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
                y, t = call(h, *mats)
            ys.append(np.asarray(y)[:c])
            ts.append(np.asarray(t))
        out.append((np.stack(ts), np.stack(ys)))
    return x, out


def _conv_out(fn, t2, idx, n, wp, b3, mode, base, sgn, sub):
    """fn (a conv3x3_out version) on the slots s < n into a sentinel-filled
    out (B, c HW) by example."""
    out = torch.full(base.shape, SENTINEL)
    fn(t2, idx, torch.tensor([n], dtype=torch.int32), wp, b3, mode, base, sgn, sub, out, HS, HS)
    return out


@pytest.mark.parametrize("fn", list(OUT_FNS))
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_out_matches_jax(mode, partial, fn):
    x, ((tx, yx), (tz, yz)) = _jax_conv3(mode)
    _, _, dx, dz = _wide_block(True)
    B, c = x.shape[:2]
    X = x.reshape(B, -1)
    xe = (X + yx.reshape(B, -1)).astype(np.float32)  # x_embed = x + eval_x(x)
    g = ((xe - yz.reshape(B, -1)) - X).astype(np.float32)  # x_embed - eval_z(z0) - z0
    idx = torch.tensor([1, 0] if partial else [0, 1], dtype=torch.int32)
    n = 1 if partial else B
    e = idx[:n].numpy()
    for t, d, base, sgn, sub, want in ((tx, dx, X, 1.0, None, xe), (tz, dz, xe, -1.0, X, g)):
        wp = fs.prep_weights(_torch(d), mode)["w3_tc"]
        out = _conv_out(OUT_FNS[fn], torch.from_numpy(t[idx.numpy()]), idx, n, wp,
                        torch.from_numpy(d["b3"]), mode, torch.from_numpy(base), sgn,
                        None if sub is None else torch.from_numpy(sub))
        err = rel_err(out[e], want[e])
        assert err <= SPLIT_TOL, (fn, sgn, err)
        dead = np.setdiff1d(np.arange(B), e)
        assert bool((out[dead] == SENTINEL).all())  # the other examples are not written


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_out_exact_is_the_float64_product(mode):
    rng = np.random.RandomState(9)
    B, c, mid = 2, 12, 128
    t = rng.standard_normal((B, mid, HS, HS)).astype(np.float32)
    pair = fs.prep_weight(torch.from_numpy((0.05 * rng.standard_normal((c, mid, 3, 3)))
                                           .astype(np.float32)), mode)
    b3 = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    base, sub = (torch.from_numpy(rng.standard_normal((B, c * HW)).astype(np.float32))
                 for _ in range(2))
    idx = torch.arange(B, dtype=torch.int32)
    out = _conv_out(so.conv3x3_out_exact, torch.from_numpy(t).reshape(B, mid, HW), idx, B,
                    fs.prep_conv3x3_out(pair, mode), b3, mode, base, -1.0, sub)
    th = _bf16(t)
    tl = _bf16(t - th)
    wh, wl = (w.double().numpy().reshape(c, -1) for w in pair)
    ch, cl = _im2col64(th), _im2col64(tl)
    mm = lambda w, col: np.einsum("ck,bkp->bcp", w, col)
    p64 = mm(wh, ch) + mm(wh, cl) + mm(wl, ch) + (mm(wl, cl) if mode == "tf32x" else 0.0)
    epi = lambda p: [((base + -1.0 * (torch.from_numpy(p) + b3[None, :, None]).reshape(B, -1))
                      - sub).numpy()]
    _one_of([out.numpy()], p64, epi)


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_out_tiled_sums_chunks_then_taps(mode):
    """Output pixel (4, 4): channel 0 at tap 0 gives 2^25 in the first
    chunk; channels 64 and 65 at tap 7 (ky 2, kx 1) give -2^25 and +1 in
    the second chunk's tap-7 partial, where the +1 rounds away."""
    mid = 2 * so.C3_MC
    t, w = torch.zeros(1, mid, HS, HS), torch.zeros(1, mid, 3, 3)
    t[0, 0, 3, 3], w[0, 0, 0, 0] = 2.0**13, 2.0**12
    t[0, 64, 5, 4], w[0, 64, 2, 1] = 2.0**13, -(2.0**12)
    t[0, 65, 5, 4], w[0, 65, 2, 1] = 1.0, 1.0
    wp = fs.prep_conv3x3_out(fs.prep_weight(w, mode), mode)
    zero, idx = torch.zeros(1, HW), torch.zeros(1, dtype=torch.int32)
    at = lambda fn: float(_conv_out(fn, t.reshape(1, mid, HW), idx, 1, wp, torch.zeros(1), mode,
                                    zero, 1.0, None)[0, 4 * HS + 4])
    assert at(so.conv3x3_out_tiled) == 0.0  # -2^25 + 1 rounds within its (chunk, tap)
    assert at(so.conv3x3_out_exact) == 1.0
    k_ordered = np.float32(0.0)  # one float32 sum over k = m * 9 + tap in order
    terms = torch.nn.functional.unfold(t, 3, padding=1)[0, :, 4 * HS + 4] * w.reshape(-1)
    for v in terms.numpy():
        k_ordered = np.float32(k_ordered + v)
    assert k_ordered == 1.0


@pytest.mark.parametrize("c", [3, 12])
def test_conv3x3_out_tiled_probe_controls(c):
    t, w = (torch.from_numpy(a) for a in tf32_probe(2, MID, c, HS, HS, 3, 40 + c))
    t = t.reshape(2, MID, HW)
    idx, zero, zb = torch.arange(2, dtype=torch.int32), torch.zeros(c), torch.zeros(2, c * HW)

    def run(fn, mode, tt, ww):
        wp = fs.prep_conv3x3_out(fs.prep_weight(ww, mode), mode)
        return _conv_out(fn, tt, idx, 2, wp, zero, mode, zb, 1.0, None)

    plain = lambda m, tt=t, ww=w: run(fs._conv3x3_out_plain, m, tt, ww)
    tf32, tf32x = (run(so.conv3x3_out_tiled, m, t, w) for m in ("tf32", "tf32x"))
    assert rel_err(tf32, plain("tf32")) <= SPLIT_TOL < min(
        rel_err(tf32, plain("f32")), rel_err(tf32, plain("f32", round_tf32(t), round_tf32(w))))
    assert rel_err(tf32x, plain("tf32x")) <= SPLIT_TOL < rel_err(tf32x, plain("tf32"))


@pytest.mark.parametrize("mode,ladder,preact,stages", [("tf32", True, True, "1c"),
                                                       ("tf32x", False, False, "1c"),
                                                       ("tf32", True, False, "1a+1b+1c")])
def test_solve_with_tiled_conv3x3_out_matches_jax(mode, ladder, preact, stages):
    x, _, dx, dz = _wide_block(preact)
    kw = dict(KW, mode=mode, warm_start=True, newton_init=True)
    if ladder:  # phase 1 capped at 2 iterations: every example re-armed at tf32x, then f32
        kw.update(tail_mode=("tf32x", "f32"), tail_start=2)
    ref = jfs.fused_broyden_solve(jnp.asarray(x), dx, dz, interpret=True, secant_refs=True,
                                  reps=1, **kw)
    ops = dict(fs._PLAIN, conv3x3_out=so.conv3x3_out_tiled)
    if stages == "1a+1b+1c":
        ops.update(conv3x3_in=so.conv3x3_in_tiled, conv1x1_mid=so.conv1x1_mid_tiled)
    full = dict(stall_guard=None, tail_mode=None, tail_start=None, line_search=False)
    got = fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, **dict(full, **kw))[0]
    _assert_match(ref, got)
    assert got.converged.all()


@pytest.mark.parametrize("mode", ["tf32", "tf32x", "f32"])
def test_w3_tc_is_the_kernels_layout(mode):
    _, _, _, dz = _wide_block(True)
    w3 = torch.from_numpy(dz["w3"])
    c, mid = w3.shape[:2]
    pair = fs.prep_weight(w3, mode)
    got = fs.prep_weights(_torch(dz), mode)["w3_tc"]
    if mode not in fs.SPLIT_MODES:  # the CUDA cores take the float32 pair
        assert got[1] is None and got[0].dtype == torch.float32
        torch.testing.assert_close(got[0], pair[0], rtol=0, atol=0)
        return
    npad = fs.c3_out_npad(c)
    for tile, half in zip(got, pair):
        assert tile.dtype == torch.bfloat16 and tile.is_contiguous()
        assert tuple(tile.shape) == (mid // 64, 9 * npad, 64)
        torch.testing.assert_close(fs.untile_w1t(tile[None], c, mid)[0], half, rtol=0, atol=0)
        # row tap * npad + co of chunk m // 64, column m % 64; zero past c
        for co, m, ky, kx in ((0, 0, 0, 0), (2, 70, 2, 1), (1, 127, 1, 2)):
            assert float(tile[m // 64, (ky * 3 + kx) * npad + co, m % 64]) == float(
                half[co, m, ky, kx])
        assert not tile.reshape(mid // 64, 9, npad, 64)[:, :, c:].any()


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_w3_cast_once_per_solve_and_mode(mode):
    x, _, dx, dz = _wide_block(True)
    seen = []

    def rec(t2, idx, count, wp, b3, m, *a):
        seen.append((m, wp))
        return fs._conv3x3_out_plain(t2, idx, count, wp, b3, m, *a)

    ops = dict(fs._PLAIN, conv3x3_out=rec)
    # a tolerance under the split modes' floor and no stall exit: every stage
    # of the ladder runs
    kw = dict(KW, eps=1e-9, stall_patience=None, mode=mode, stall_guard=None, newton_init=True,
              warm_start=True, tail_mode=("tf32x", "f32"), tail_start=(2, 4), line_search=False)
    fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, **kw)
    # net x and net z in each stage's mode: one cast each, reused by every
    # evaluation of that net and mode
    stages = {m for m, _ in seen}
    assert stages == {mode, "tf32x", "f32"}
    assert len({id(wp) for _, wp in seen}) == 2 * len(stages) < len(seen)
    for m, wp in seen:
        assert wp[0].dtype == (torch.bfloat16 if m in fs.SPLIT_MODES else torch.float32)


@pytest.mark.parametrize("c,W,bytes_", [(3, 32, 105600), (12, 16, 83072), (48, 8, 62592),
                                        (12, 32, 124032), (48, 32, 124032)])
def test_conv3x3_out_smem_is_the_kernels(c, W, bytes_):
    # c3_smem_bytes(TW, NT, 2, 2): 2 (8 + 2) (TW + 2) 128 + 2 9 8 NT 128 + 128,
    # NT the block's output tiles (C3_SOLVE_GROUPS)
    assert fs.conv3x3_out_smem(c, W) == bytes_


def test_split_out_tiles_fit_every_shape_the_kernel_takes():
    for c in (1, 3, 8, 12, 16, 48):
        for W in (8, 16, 32):
            fs.check_conv3x3_tc("conv3x3_out", c, 512, 8, W, fs.C3_OUT_ROWS, split_out=True)


def test_check_conv3x3_tc_refuses_split_tiles_past_the_shared_memory(monkeypatch):
    monkeypatch.setattr(fs, "TC_SMEM_MAX", 100_000)
    fs.check_conv3x3_tc("conv3x3_out", 48, 512, 8, 8, fs.C3_OUT_ROWS, split_out=True)
    with pytest.raises(ValueError, match="105600 bytes of shared memory"):
        fs.check_conv3x3_tc("conv3x3_out", 3, 512, 32, 32, fs.C3_OUT_ROWS, split_out=True)
