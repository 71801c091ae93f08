"""The re-attachment's 1x1 product in mode bf16 on the CPU:
``rv_conv1x1_mid``, whose kernel runs on the tensor cores
(``csrc/mma_gemm.cuh``, ``EPI_AFFINE`` with the input transform swish or
swish' applied once per element as its panel is staged).

The kernel sums each K tile of 64 channels into a fresh float32 partial and
adds the partials in order; ``ops/sum_order.py::rv_conv1x1_mid_tiled`` is the
plain version summed that way and stands in for it here.
``rv_conv1x1_mid_exact`` (float64 sums, one rounding) reads the
re-attachment's sum-order floor on the card (``chip_smoke.py`` phase 6).

* ``rv_conv1x1_mid_tiled`` at the flagship's mid 512 (8 K tiles), 8x8, 2
  examples, against the JAX package's bf16 product (``_make_dot("bf16")``,
  ``implicit_normalizing_flows_tpu/ops/fused_solve.py``) of
  ``_net_vjp_in_kernel``'s two forms, ``h2 = W2 swish(h1) + b2`` and ``t1 =
  W2^T (t2 swish'(h2))``, with its kernels' swish family: by rel_norm
  within 2e-5 (``tests/test_torch_tc_order.py``'s limit for the final
  pair's product of the same form), the control (the plain version in mode
  f32) above it.
* ``rv_conv1x1_mid_exact`` against the float64 product (numpy) to one
  float32 ulp (and the bias added after it, as the plain version adds it).
* The re-attachment VJP with ``rv_conv1x1_mid_tiled`` against the same VJP
  with ``rv_conv1x1_mid_exact``, at mid 256 (4 K tiles), 8x8, 2 examples,
  with and without preact: the four products the VJP makes with it (h2 and
  t1 of both nets) by rel_norm within ``chip_smoke.py``'s ``REATTACH_TOL``
  2e-5 (measured here: about 1e-7); the control, the plain VJP in mode f32,
  reads above it against the exact VJP on every output a product reaches.
  The whole VJP's outputs are the card's check (phase 6): at this size one
  intermediate that a float32 ulp moves across a bfloat16 tie moves a
  weight gradient by 1e-5 to 1e-4, whatever the order (the plain path's own
  order reads 9e-6 to 9e-5 against the exact one over seeds), where at the
  flagship's B 64 and real inputs the floor reads 3e-6 to 7e-6.
* The kernel's weights: in mode bf16 W2 and W2^T cast once to bfloat16,
  exactly, contiguous in the (mid, mid, 1, 1) layout the kernel indexes;
  modes f32 / tf32 keep ``prep_weight``'s float32 split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.fused_solve import _dswish, _make_dot, _swish
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm

MID, H, W, B = 512, 8, 8, 2
HW = H * W
PRODUCT_TOL = 2e-5   # test_torch_tc_order.py's PRODUCT_TOL
REATTACH_TOL = 2e-5  # chip_smoke.py's REATTACH_TOL["bf16"]
NAMES = ("w1", "w2", "w3", "b1", "b2", "b3", "betas")


def operands(act, seed, mid=MID):
    """(inp, inh, w (mid, mid, 1, 1), bias or None, beta (1,)) numpy: h1 for
    swish (inh = inp, the bias b2), (t2, h2) for dswish (no bias)."""
    rng = np.random.RandomState(seed)
    inp = rng.standard_normal((B, mid, HW)).astype(np.float32)
    inh = inp if act == "swish" else rng.standard_normal((B, mid, HW)).astype(np.float32)
    w = (rng.standard_normal((mid, mid, 1, 1)) / np.sqrt(mid)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(mid)).astype(np.float32) if act == "swish" else None
    return inp, inh, w, bias, np.array([1.0 + 0.1 * rng.standard_normal()], np.float32)


def run(fn, inp, inh, w, bias, beta, act, mode):
    out = torch.zeros(B, inp.shape[1], HW)
    t = lambda a: None if a is None else torch.from_numpy(a)
    fn(t(inp), t(inh), torch.tensor([B], dtype=torch.int32),
       ig.prep_rv_mid_weight(torch.from_numpy(w), mode), t(bias), 1.0, t(beta), act, mode,
       out, H, W)
    return out.numpy()


@pytest.mark.parametrize("act", ["swish", "dswish"])
def test_rv_conv1x1_mid_tiled_matches_jax(act):
    inp, inh, w, bias, beta = operands(act, 3 + len(act))
    b = jnp.float32(beta[0])
    ref = []
    for n in range(B):
        x, h = jnp.asarray(inp[n]), jnp.asarray(inh[n])
        a = _swish(x, b) if act == "swish" else x * _dswish(h, b)
        with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
            y = np.asarray(_make_dot("bf16")(jnp.asarray(w[:, :, 0, 0]), a))
        ref.append(y if bias is None else y + bias[:, None])
    ref = np.stack(ref)
    err = rel_norm(run(so.rv_conv1x1_mid_tiled, inp, inh, w, bias, beta, act, "bf16"), ref)
    ctrl = rel_norm(run(ig._rv_conv1x1_mid_plain, inp, inh, w, bias, beta, act, "f32"), ref)
    assert err <= PRODUCT_TOL < ctrl, (err, ctrl)


def _ulps(got, want):
    """|got - want| in float32 ulps of want."""
    want32 = want.astype(np.float32)
    return float(np.max(np.abs(got.astype(np.float64) - want32) / np.spacing(np.abs(want32))))


@pytest.mark.parametrize("act", ["swish", "dswish"])
def test_rv_conv1x1_mid_exact_is_the_float64_product(act):
    inp, inh, w, bias, beta = operands(act, 30 + len(act))
    a = ig._act(torch.from_numpy(inp), torch.from_numpy(inh), torch.from_numpy(beta), act)
    bf = lambda v: v.to(torch.bfloat16).double().numpy()
    want = np.einsum("mk,bkp->bmp", bf(torch.from_numpy(w[:, :, 0, 0])), bf(a))
    got = run(so.rv_conv1x1_mid_exact, inp, inh, w, bias, beta, act, "bf16")
    if bias is None:
        assert _ulps(got, want) <= 1.0
    else:  # the product within one ulp, then + b2 in float32: one of three sums
        p32 = want.astype(np.float32)
        cands = [q + bias[:, None] for q in (np.nextafter(p32, np.float32(-np.inf)), p32,
                                             np.nextafter(p32, np.float32(np.inf)))]
        assert np.all(np.any([got == c for c in cands], axis=0))


def _nets(c, preact, seed, mid=256):
    """Both nets' conv_forward_data dicts at idim ``mid``: kernels of about
    the contraction the flagship's spectral norm leaves, biases, slopes."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def net():
        return {"w1": t(rng.standard_normal((mid, c, 3, 3)) * 0.5 / np.sqrt(9 * c)),
                "w2": t(rng.standard_normal((mid, mid, 1, 1)) * 0.5 / np.sqrt(mid)),
                "w3": t(rng.standard_normal((c, mid, 3, 3)) * 0.5 / np.sqrt(9 * mid)),
                "b1": t(0.1 * rng.standard_normal(mid)), "b2": t(0.1 * rng.standard_normal(mid)),
                "b3": t(0.1 * rng.standard_normal(c)),
                "betas": t(1.0 + 0.1 * rng.standard_normal(3)), "preact": preact}

    x = rng.standard_normal((B, c, H, W)) * 0.5
    return (t(x), t(x + 0.2 * rng.standard_normal(x.shape)), t(rng.standard_normal(x.shape)),
            net(), net())


def _flat(g):
    return [("d_x", g[0])] + [(f"{n}.{k}", h[k]) for n, h in (("x", g[1]), ("z", g[2]))
                              for k in NAMES]


def _recorded(fn, seen):
    """``fn`` as an rv_conv1x1_mid op that also keeps a copy of each output."""
    def op(inp, inh, count, wp, bias, alpha, beta_in, act, mode, out, H, W):
        fn(inp, inh, count, wp, bias, alpha, beta_in, act, mode, out, H, W)
        seen.append(out.clone())
    return op


@pytest.mark.parametrize("c,preact", [(3, True), (3, False), (12, True)])
def test_reattach_with_tiled_product_within_tol_of_exact(c, preact):
    x, z_hat, u, dx, dz = _nets(c, preact, 40 + c + preact)
    runs = {}
    for name, fn in (("exact", so.rv_conv1x1_mid_exact), ("tiled", so.rv_conv1x1_mid_tiled)):
        seen = runs[name] = []
        ig._reattach_vjp(x, z_hat, u, dx, dz, dict(ig._PLAIN, rv_conv1x1_mid=_recorded(fn, seen)),
                         "bf16")
    # h2 and t1 of net x, then of net z, as the VJP makes and uses them
    assert len(runs["tiled"]) == 4
    worst = max(rel_norm(a, b) for a, b in zip(runs["tiled"], runs["exact"]))
    assert worst <= REATTACH_TOL, worst
    # the whole VJP: its control, the plain VJP in mode f32, reads above the
    # limit against the VJP with the exact product on every output a
    # product reaches (b3's gradient is the sum of the cotangent; the first
    # slope's gradient is exactly zero without preact)
    vjp = lambda ops, mode: _flat(ig._reattach_vjp(x, z_hat, u, dx, dz, ops, mode))
    ref = vjp(dict(ig._PLAIN, rv_conv1x1_mid=so.rv_conv1x1_mid_exact), "bf16")
    base = lambda n: u if n == "d_x" else None  # d_x = u + J^T u
    least = min((rel_norm(a, b, base(n)), n) for (n, a), (_, b) in zip(vjp(ig._PLAIN, "f32"), ref)
                if not n.endswith(".b3") and (preact or not n.endswith(".betas")))
    assert least[0] > REATTACH_TOL, least


@pytest.mark.parametrize("mode", ["bf16", "tf32", "f32"])
def test_rv_conv1x1_mid_weights_cast_once_exactly(mode):
    rng = np.random.RandomState(len(mode))
    w2 = torch.from_numpy((rng.standard_normal((MID, MID, 1, 1)) / np.sqrt(MID))
                          .astype(np.float32))
    for w in (w2, ig.transpose_weights(torch.zeros(MID, 3, 3, 3), w2,
                                       torch.zeros(3, MID, 3, 3))[1]):
        wp = ig.prep_rv_mid_weight(w, mode)
        want = ig.prep_weight(w, mode)
        if mode == "bf16":
            assert wp[1] is None and wp[0].dtype == torch.bfloat16
            assert wp[0].shape == (MID, MID, 1, 1)
            # the kernel reads w[m][k] at m * MID + k
            assert wp[0].is_contiguous() and wp[0].stride() == (MID, 1, 1, 1)
            torch.testing.assert_close(wp[0].float(), want[0], rtol=0, atol=0)
        else:
            assert all(a is b or (a is not None and torch.equal(a, b))
                       for a, b in zip(wp, want))
            assert wp[0].dtype == torch.float32
