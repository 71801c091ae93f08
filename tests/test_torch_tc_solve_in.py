"""The forward solve's c -> mid 3x3 product ``conv3x3_in`` (``[swish] ->
conv3x3 c -> mid + b1 -> swish``, on an active list) in the split modes on
the CPU. On the card it runs on the c -> mid tensor-core kernel
(``csrc/conv3x3_in_tc.cuh``, epilogue ``EPI_SWISH``), which sums the
im2col's k = ci * 9 + ky * 3 + kx in K tiles of 16, each into fresh float32
partials, one of hi*hi and one of the small passes, and returns at once in
the blocks of dead slots. ``ops/sum_order.py``'s ``conv3x3_in_tiled`` sums
that way and stands in for the kernel here; ``conv3x3_in_exact`` (every
pass summed in float64, rounded once) reads the solve's sum-order floor of
``chip_smoke.py`` phases 3 and 15.

* ``conv3x3_in_exact`` / ``_tiled`` against swish(h1) of net x at x,
  recorded from ``_block_fwd_kernel`` inside the JAX package's
  ``fused_block_forward`` in interpret mode (``tests/test_torch_tc_conv3x3_in.py``'s
  recording), on a recipe-shaped block at idim 128, 3x8x8, preact on and
  off, tf32 and tf32x, on the whole list and on a partial permuted one (the
  slots read example idx[s]; the dead slots stay bitwise as they were), by
  ``chip_smoke.py``'s ``SPLIT_TOL`` (max error over the largest entry, at
  least 1).
* ``conv3x3_in_exact`` against the float64 product of the split (numpy):
  the epilogue of its float32 rounding or of a float32 beside it.
* ``conv3x3_in_tiled`` sums in the kernel's order: on inputs built so that
  one output's K tiles are {+2^25} and {-2^25, +1}, that order reads
  swish(0), where the exact sum and a k-ordered float32 sum read swish(1).
* On the precision probe (``ops/precision_probe.py``) the tiled product
  lies within SPLIT_TOL of the plain version of its mode, and the controls
  (plain f32 and native TF32 against tf32, plain tf32 against tf32x) above.
* The whole forward solve with the tiled 1a (and with the tiled 1a and 1b
  together) against JAX's ``fused_broyden_solve`` in interpret mode, at
  ``tests/test_torch_fused_solve.py``'s tolerances: tf32 with the ladder
  (preact on) and tf32x (preact off).
* W1's split cast to bfloat16 once per solve and mode (``prep_weights``'
  ``w1_in``), exactly, and the one pair that both ``conv3x3_in`` and the
  merged forward's ``lin_conv3x3_in`` take.
* The shapes the route takes: ``check_conv3x3_tc`` refuses two im2col tiles
  that outgrow an SM's shared memory (c 48 at W 16 and 32), and
  ``conv3x3_in_smem`` is the kernel's ``c3i_smem_bytes``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_block as fb
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32, tf32_probe

from test_torch_fused_solve import KW, _assert_match, _torch
from test_torch_tc_conv3x3_in import (HS, HW, MID, _bf16, _im2col64, _jax_lin, _one_of,
                                      _wide_block)
from test_torch_tc_split import rel_err

SPLIT_TOL = 1e-4  # chip_smoke.py phases 2 / 14's limit for the split modes
IN_FNS = {"exact": so.conv3x3_in_exact, "tiled": so.conv3x3_in_tiled}
SENTINEL = -7.25


def _betas(d):
    return [float(v) for v in d["betas"]]


def _conv_in(fn, x, idx, count, wp, d, preact, mode):
    """fn (a conv3x3_in version) on x's examples idx[:count] into a
    sentinel-filled out (B, MID, HW) by slot."""
    out = torch.full((x.shape[0], wp[0].shape[0], x.shape[2] * x.shape[3]), SENTINEL)
    fn(x, idx, count, wp, torch.from_numpy(d["b1"]), _betas(d), preact, mode, out)
    return out


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_in_matches_jax(mode, preact, partial):
    x, _, dx, _ = _wide_block(preact)
    h1, _, _ = _jax_lin(preact, mode)
    want = np.asarray(jfs._swish(jnp.asarray(h1), jnp.float32(_betas(dx)[1])))
    B = x.shape[0]
    idx = torch.tensor([1, 0] if partial else [0, 1], dtype=torch.int32)
    n = 1 if partial else B
    wp = fs.prep_weights(_torch(dx), mode)["w1_in"]
    for name, fn in IN_FNS.items():
        out = _conv_in(fn, torch.from_numpy(x), idx, torch.tensor([n], dtype=torch.int32), wp,
                       dx, preact, mode)
        err = rel_err(out[:n], want[idx[:n].numpy()])
        assert err <= SPLIT_TOL, (name, err)
        assert bool((out[n:] == SENTINEL).all())  # the dead slots are not written


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_in_exact_is_the_float64_product(mode):
    x, _, dx, _ = _wide_block(True)
    rng = np.random.RandomState(8)
    x = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    betas = _betas(dx)
    pair = fs.prep_weight(torch.from_numpy(dx["w1"]), mode)
    B = x.shape[0]
    idx, cnt = torch.arange(B, dtype=torch.int32), torch.tensor([B], dtype=torch.int32)
    out = _conv_in(so.conv3x3_in_exact, torch.from_numpy(x), idx, cnt,
                   fs.prep_conv1x1_mid(pair, mode), dx, True, mode)
    xs = fs.swish(torch.from_numpy(x), betas[0]).numpy()
    xh = _bf16(xs)
    xl = _bf16(xs - xh)
    wh, wl = (w.double().numpy().reshape(MID, -1) for w in pair)
    ch, cl = _im2col64(xh), _im2col64(xl)
    mm = lambda w, c: np.einsum("mk,bkp->bmp", w, c)
    p64 = mm(wh, ch) + mm(wh, cl) + mm(wl, ch) + (mm(wl, cl) if mode == "tf32x" else 0.0)
    b1 = torch.from_numpy(dx["b1"])[None, :, None]
    _one_of([out.numpy()], p64,
            lambda p: [fs.swish(torch.from_numpy(p) + b1, betas[1]).numpy()])


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv3x3_in_tiled_sums_k_tiles_of_16(mode):
    """k = ci * 9 + ky * 3 + kx: k 0 (ci 0, tap 0) in the first K tile;
    k 16 and 17 (ci 1, taps 7 and 8) in the second."""
    x, w = torch.zeros(1, 2, HS, HS), torch.zeros(1, 2, 3, 3)
    x[0, 0, 3, 3], w[0, 0, 0, 0] = 2.0**13, 2.0**12  # output (4, 4), tap 0: 2^25
    x[0, 1, 5, 4], w[0, 1, 2, 1] = 2.0**13, -(2.0**12)  # tap 7: -2^25
    x[0, 1, 5, 5], w[0, 1, 2, 2] = 1.0, 1.0  # tap 8
    wp = fs.prep_conv1x1_mid(fs.prep_weight(w, mode), mode)
    one = torch.ones(1, dtype=torch.int32)
    d = {"b1": np.zeros(1, np.float32), "betas": np.ones(3, np.float32)}
    at = lambda fn: float(_conv_in(fn, x, one - 1, one, wp, d, False, mode)[0, 0, 4 * HS + 4])
    swish = lambda v: float(fs.swish(torch.tensor(v), 1.0))
    assert at(so.conv3x3_in_tiled) == swish(0.0)  # -2^25 + 1 rounds within its tile
    assert at(so.conv3x3_in_exact) == swish(1.0)
    k_ordered = np.float32(0.0)  # one float32 sum over k in order
    terms = torch.nn.functional.unfold(x, 3, padding=1)[0, :, 4 * HS + 4] * w.reshape(-1)
    for v in terms.numpy():
        k_ordered = np.float32(k_ordered + v)
    assert k_ordered == 1.0


@pytest.mark.parametrize("c", [3, 12])
def test_conv3x3_in_tiled_probe_controls(c):
    x, w = (torch.from_numpy(a) for a in tf32_probe(2, c, MID, HS, HS, 3, 20 + c))
    idx, cnt = torch.arange(2, dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    d = {"b1": np.zeros(MID, np.float32), "betas": np.ones(3, np.float32)}

    def run(fn, mode, xx, ww):
        return _conv_in(fn, xx, idx, cnt, fs.prep_conv1x1_mid(fs.prep_weight(ww, mode), mode),
                        d, False, mode)

    plain = lambda m, xx=x, ww=w: run(fs._conv3x3_in_plain, m, xx, ww)
    tf32, tf32x = (run(so.conv3x3_in_tiled, m, x, w) for m in ("tf32", "tf32x"))
    assert rel_err(tf32, plain("tf32")) <= SPLIT_TOL < min(
        rel_err(tf32, plain("f32")), rel_err(tf32, plain("f32", round_tf32(x), round_tf32(w))))
    assert rel_err(tf32x, plain("tf32x")) <= SPLIT_TOL < rel_err(tf32x, plain("tf32"))


@pytest.mark.parametrize("mode,ladder,preact,stages", [("tf32", True, True, "1a"),
                                                       ("tf32x", False, False, "1a"),
                                                       ("tf32", True, False, "1a+1b")])
def test_solve_with_tiled_conv3x3_in_matches_jax(mode, ladder, preact, stages):
    x, _, dx, dz = _wide_block(preact)
    kw = dict(KW, mode=mode, warm_start=True, newton_init=True)
    if ladder:  # phase 1 capped at 2 iterations: every example re-armed at tf32x, then f32
        kw.update(tail_mode=("tf32x", "f32"), tail_start=2)
    ref = jfs.fused_broyden_solve(jnp.asarray(x), dx, dz, interpret=True, secant_refs=True,
                                  reps=1, **kw)
    ops = dict(fs._PLAIN, conv3x3_in=so.conv3x3_in_tiled)
    if stages == "1a+1b":
        ops["conv1x1_mid"] = so.conv1x1_mid_tiled
    full = dict(stall_guard=None, tail_mode=None, tail_start=None, line_search=False)
    got = fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, **dict(full, **kw))[0]
    _assert_match(ref, got)
    assert got.converged.all()


@pytest.mark.parametrize("mode", ["tf32", "tf32x", "f32"])
def test_w1_cast_once_and_shared_with_the_linearisation(mode):
    x, _, dx, dz = _wide_block(True)
    seen = {"conv3x3_in": [], "lin_conv3x3_in": []}

    def rec(name, plain):
        def run(inp, *a):
            seen[name].append(a[2] if name == "conv3x3_in" else a[0])
            return plain(inp, *a)
        return run

    ops = dict(fb._PLAIN_OPS, conv3x3_in=rec("conv3x3_in", fs._conv3x3_in_plain),
               lin_conv3x3_in=rec("lin_conv3x3_in", fb._lin_conv3x3_in_plain))
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)
    fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, linearise=True,
              **dict(full, **KW), mode=mode)
    lin_x, lin_z = seen["lin_conv3x3_in"]  # net x at x, net z at the best iterate
    assert seen["conv3x3_in"] and all(w is lin_z for w in seen["conv3x3_in"])
    for wp, d in ((lin_x, dx), (lin_z, dz)):
        pair = fs.prep_weight(torch.from_numpy(d["w1"]), mode)
        for half, want in zip(wp, pair):
            if want is None:
                assert half is None
                continue
            assert half.dtype == (torch.bfloat16 if mode in fs.SPLIT_MODES else torch.float32)
            assert half.is_contiguous() and half.shape == d["w1"].shape
            torch.testing.assert_close(half.float(), want, rtol=0, atol=0)


@pytest.mark.parametrize("c,W,panels,ok", [
    (3, 32, 2, True), (12, 16, 2, True), (48, 8, 2, True),  # the flagship's scales
    (48, 16, 2, False), (48, 32, 2, False),  # two tiles of K 432 at 128 pixels
    (48, 16, 1, True),  # one tile (mode bf16's) fits
])
def test_check_conv3x3_tc_refuses_tiles_past_the_shared_memory(c, W, panels, ok):
    check = lambda: fs.check_conv3x3_tc("conv3x3_in", c, 512, 64 // W * 8, W,
                                        fs.conv3x3_in_rows(W), panels=panels)
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="bytes of shared memory"):
            check()


@pytest.mark.parametrize("c,W,panels,bytes_", [(3, 32, 2, 23296), (12, 16, 2, 70784),
                                               (48, 8, 2, 133760), (48, 32, 2, 266368)])
def test_conv3x3_in_smem_is_the_kernels(c, W, panels, bytes_):
    assert fs.conv3x3_in_smem(c, W, panels) == bytes_
