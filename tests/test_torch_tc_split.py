"""The forward solve's 1x1 product in the split modes on the CPU:
``conv1x1_mid`` in ``tf32`` / ``tf32x``, whose kernel runs the bf16 split's
3 or 4 passes on the tensor cores (``csrc/mma_gemm.cuh``, PASSES 3 / 4).

The kernel sums each K tile of 64 channels into two fresh float32 partials,
one of hi*hi and one of the small passes (hi*lo + lo*hi [+ lo*lo]), adds each
to its float32 sum and the two sums at the end;
``ops/sum_order.py::conv1x1_mid_tiled`` is the plain version summed that way
and stands in for the kernel here. ``conv1x1_mid_exact`` (every pass summed
in float64, rounded once) reads the solve's sum-order floor on the card
(``chip_smoke.py`` phase 3).

* ``conv1x1_mid_tiled`` at the flagship's mid 512 (8 K tiles), 8x8, 2
  examples, against the JAX package's split product (``_make_dot("tf32" |
  "tf32x")``, ``implicit_normalizing_flows_tpu/ops/fused_solve.py``) plus b2
  and its kernels' swish: by ``chip_smoke.py`` phase 2's measure (max error
  over the largest entry, at least 1) within 1e-5: the same exact products
  summed in another order (``tests/test_torch_tf32_probe.py`` holds the
  plain products at rtol 1e-5). On the precision probe
  (``ops/precision_probe.py``) the controls must read above that: plain
  ``f32`` and native TF32 against ``tf32``, and ``tf32`` against ``tf32x``.
* ``conv1x1_mid_exact`` against the float64 product of the split (numpy) to
  one float32 ulp, followed by the plain version's ``+ b2`` and swish.
* The whole forward solve with ``conv1x1_mid_tiled`` (the plain solve
  otherwise; mode f32's stage runs the plain version, as the wrapper sends
  it to the CUDA cores) against the JAX package's ``fused_broyden_solve`` in
  interpret mode, at idim 128 (2 K tiles), 3x8x8, batch 2, with the
  tolerances of ``tests/test_torch_fused_solve.py``: root and residual rtol
  1e-4 / atol 1e-5, nstep within one, converged and protective-break flags
  equal.
* The kernel's weights: in the split modes W2's hi and lo halves cast once
  to bfloat16, exactly, contiguous in the (mid, mid, 1, 1) layout the kernel
  indexes; modes f32 and bf16 keep the float32 pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers.implicit_block import ImplicitBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_tpu.ops.fused_solve import _make_dot, _swish
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32, tf32_probe

from test_torch_fused_solve import KW, _assert_match, _torch

MID, H, W, B = 512, 8, 8, 2
HW = H * W
TOL = 1e-5


def rel_err(a, b):
    """chip_smoke.py's phase-2 measure: max error over max(max|b|, 1)."""
    a, b = (torch.as_tensor(np.asarray(t, np.float64)) for t in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def operands(data, seed):
    """(t1 (B, MID, HW), w2 (MID, MID, 1, 1), b2 (MID,), beta2) numpy:
    the precision probe's operands, or seeded normal ones."""
    rng = np.random.RandomState(seed)
    if data == "probe":
        x, w = tf32_probe(B, MID, MID, H, W, 1, seed)
        t1 = x.reshape(B, MID, HW)
    else:
        t1 = rng.standard_normal((B, MID, HW)).astype(np.float32)
        w = (rng.standard_normal((MID, MID, 1, 1)) / np.sqrt(MID)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(MID)).astype(np.float32)
    return t1, w, b2, np.float32(1.0 + 0.1 * rng.standard_normal())


def run(fn, t1, w, b2, beta2, mode, wp=None):
    out = torch.zeros(B, MID, HW)
    if wp is None:
        wp = fs.prep_conv1x1_mid(fs.prep_weight(torch.from_numpy(w), mode), mode)
    fn(torch.from_numpy(t1), torch.tensor([B], dtype=torch.int32), wp,
       torch.from_numpy(b2), float(beta2), mode, out, H, W)
    return out.numpy()


def jax_conv1x1_mid(t1, w, b2, beta2, mode):
    """h2 = _make_dot(mode)(W2, t) + b2; swish(h2, beta2), per example."""
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        dot = _make_dot(mode)
        return np.stack([np.asarray(_swish(dot(jnp.asarray(w[:, :, 0, 0]), jnp.asarray(t))
                                           + jnp.asarray(b2)[:, None], jnp.float32(beta2)))
                         for t in t1])


@pytest.mark.parametrize("data", ["probe", "normal"])
@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv1x1_mid_tiled_matches_jax(mode, data):
    t1, w, b2, beta2 = operands(data, 5 + len(mode))
    ref = jax_conv1x1_mid(t1, w, b2, beta2, mode)
    err = rel_err(run(so.conv1x1_mid_tiled, t1, w, b2, beta2, mode), ref)
    assert err <= TOL, err
    if data == "probe":  # what a kernel that ran another error model would read
        other = "tf32x" if mode == "tf32" else "tf32"
        controls = {other: rel_err(run(so.conv1x1_mid_tiled, t1, w, b2, beta2, other), ref)}
        if mode == "tf32":
            controls["f32"] = rel_err(run(fs._conv1x1_mid_plain, t1, w, b2, beta2, "f32"), ref)
            native = (round_tf32(torch.from_numpy(w)), None)
            controls["native tf32"] = rel_err(run(
                fs._conv1x1_mid_plain, round_tf32(torch.from_numpy(t1)).numpy(), w, b2, beta2,
                "f32", wp=native), ref)
        assert all(v > TOL for v in controls.values()), controls


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
def test_conv1x1_mid_exact_is_the_float64_product(mode):
    t1, w, b2, beta2 = operands("normal", 20 + len(mode))
    xh = _bf16(t1)
    xl = _bf16(t1 - xh.astype(np.float32))
    w2 = w[:, :, 0, 0]
    wh = _bf16(w2)
    wl = _bf16(w2 - wh.astype(np.float32))
    mm = lambda a, x: np.einsum("mk,bkp->bmp", a, x)
    prod = mm(wh, xh) + mm(wh, xl) + mm(wl, xh) + (mm(wl, xl) if mode == "tf32x" else 0.0)
    got = run(so.conv1x1_mid_exact, t1, w, b2, beta2, mode)
    # the product rounded once, within one float32 ulp, then the plain
    # version's float32 epilogue: got is one of the three candidates
    p32 = prod.astype(np.float32)
    epi = lambda p: fs.swish(torch.from_numpy(p) + torch.from_numpy(b2)[None, :, None],
                             float(beta2)).numpy()
    cands = [epi(q) for q in (np.nextafter(p32, np.float32(-np.inf)), p32,
                              np.nextafter(p32, np.float32(np.inf)))]
    assert np.all(np.any([got == c for c in cands], axis=0))
    assert np.mean(got == cands[1]) > 0.99  # nearly all to the bit


@pytest.fixture(scope="module")
def wide_nets():
    """A recipe-shaped block at idim 128 (two K tiles of the 1x1), 3x8x8,
    batch 2, JAX-initialised: the inputs and both nets' conv_forward_data
    dicts, as numpy."""
    def make_net():
        return build_conv_net((3, 8, 8), 128, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3,
                              3, "swish", preact=True, dropout=0.0, sn_atol=None,
                              sn_rtol=None, learn_p=False, first_resblock=False)

    block = ImplicitBlock(make_net(), make_net(), n_dist="poisson")
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    to_np = lambda d: {k: (np.asarray(a) if k != "preact" else a) for k, a in d.items()}
    return (x, to_np(block.nnet_x.conv_forward_data(sub("nnet_x"))),
            to_np(block.nnet_z.conv_forward_data(sub("nnet_z"))))


@pytest.mark.parametrize("mode,ladder", [("tf32", False), ("tf32x", False), ("tf32", True)])
def test_solve_with_tiled_conv1x1_mid_matches_jax(wide_nets, mode, ladder):
    x, dx, dz = wide_nets
    kw = dict(KW, mode=mode, warm_start=True, newton_init=True)
    if ladder:  # phase 1 capped at 2 iterations: every example re-armed at tf32x, then f32
        kw.update(tail_mode=("tf32x", "f32"), tail_start=2)
    ref = jfs.fused_broyden_solve(jnp.asarray(x), dx, dz, interpret=True, secant_refs=True,
                                  reps=1, **kw)
    ops = dict(fs._PLAIN, conv1x1_mid=so.conv1x1_mid_tiled)
    full = dict(stall_guard=None, tail_mode=None, tail_start=None, line_search=False)
    got = fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, **dict(full, **kw))[0]
    _assert_match(ref, got)
    assert got.converged.all()


@pytest.mark.parametrize("mode", ["tf32", "tf32x", "f32", "bf16"])
def test_conv1x1_mid_weights_cast_once_exactly(mode):
    rng = np.random.RandomState(len(mode))
    w2 = torch.from_numpy((rng.standard_normal((MID, MID, 1, 1)) / np.sqrt(MID))
                          .astype(np.float32))
    data = {"w1": torch.zeros(MID, 3, 3, 3), "w2": w2, "w3": torch.zeros(3, MID, 3, 3)}
    wp = fs.prep_weights(data, mode)
    pair = fs.prep_weight(w2, mode)
    if mode in ("tf32", "tf32x"):
        for half, want in zip(wp["w2_mid"], pair):
            assert half.dtype == torch.bfloat16 and half.shape == (MID, MID, 1, 1)
            # the kernel reads w[m][k] at m * MID + k
            assert half.is_contiguous() and half.stride() == (MID, 1, 1, 1)
            torch.testing.assert_close(half.float(), want, rtol=0, atol=0)
        # the halves are the split of w2: hi + lo within float32 of w2
        assert float((wp["w2_mid"][0].double() + wp["w2_mid"][1].double()
                      - w2.double()).abs().max()) <= 2.0**-16 * float(w2.abs().max())
    else:
        assert wp["w2_mid"] is wp["w2"]
        assert wp["w2_mid"][0].dtype == torch.float32
