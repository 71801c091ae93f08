"""The generic Broyden solver's rank-1 secant update: the port's plain version
(what ``broyden_update`` runs for CPU tensors, and what ``chip_smoke.py``
holds the CUDA kernel against on the card) and the model of its kernel's
order of sums (``ops.sum_order.broyden_update_tiled``) against the JAX
package's ``fused_broyden_update`` in interpret mode and against the XLA
formulas of its solver (``ops/broyden.py:294-312``), on the same numpy
inputs.

Grid, the kernel's warp form: D 6 (POWER) / 63 (BSDS300), B 8, K 4
(backward budget) / 30 (forward), col 0 / K // 2 / K - 1. Its cluster form:
D 1024 (the FC blocks at the last 8x8 scale) / 3072 (a 32x32 image), B 4, K
30, col 0 / 1 / 10 / 29; D 1027 (a width that float4 vectors do not split);
D 32772, K 8, col 3 (past the registers: the stream kernel). The planes
``>= col`` are zero as in the solver; row 1 (and 5 where B is 8) inactive,
row 3 with a zero denominator (delta_gx = 0: u is inf or NaN and scrubbed
to 0). Tolerance atol 1e-5:
float32 on both sides, only the summation order differs (the factors are
drawn at a solver's scale, so the values are O(1)).

The port keeps U plane-major, ``UTs`` (B, K, D), where the JAX solver's
``Us`` is (B, D, K): the tests transpose at the boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.broyden import _PREC
from implicit_normalizing_flows_tpu.ops.pallas_kernels import fused_broyden_update
from implicit_normalizing_flows_torch.ops import broyden_update as bu
from implicit_normalizing_flows_torch.ops.broyden_update import (broyden_update,
                                                                  broyden_update_plain)
from implicit_normalizing_flows_torch.ops.sum_order import (broyden_update_exact,
                                                            broyden_update_tiled)

ZERO_DENOM = 3
WHERE = {"first": lambda K: 0, "mid": lambda K: K // 2, "last": lambda K: K - 1}
# (D, K, col, B) by test id; the tabular ids as before image widths were added
CASES = {f"{w}-{K}-{D}": (D, K, WHERE[w](K), 8)
         for w in WHERE for K in (4, 30) for D in (6, 63)}
CASES.update({f"col{col}-30-{D}": (D, 30, col, 4)
              for D in (1024, 3072) for col in (0, 1, 10, 29)})
CASES["col10-30-1027"] = (1027, 30, 10, 4)
CASES["col3-8-32772"] = (32772, 8, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread for this file: the tiled model's many small ops
    slow down many times over when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inactive_rows(B):
    return (1, 5) if B > 5 else (1,)


def make_inputs(D, K, col, seed, B=8):
    """The JAX layout: Us (B, D, K), VTs (B, K, D), dx, dgx, gx, active."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    # factors at a solver's scale: U V^T x of the order of x
    Us = rng.normal(0.0, 0.3 / np.sqrt(D), (B, D, K))
    VTs = rng.normal(0.0, 0.3 / np.sqrt(D), (B, K, D))
    Us[:, :, col:] = 0.0
    VTs[:, col:, :] = 0.0
    dx = rng.normal(size=(B, D))
    # a residual change like a contraction's: -(I + J) dx, so vT . dgx ~ |dx|^2
    dgx = -dx - 0.3 * rng.normal(size=(B, D))
    dgx[ZERO_DENOM] = 0.0
    gx = rng.normal(size=(B, D))
    active = np.ones(B, bool)
    active[list(inactive_rows(B))] = False
    return f32(Us), f32(VTs), f32(dx), f32(dgx), f32(gx), active


def to_port(inputs):
    """The JAX layout's inputs as the port's tensors: U plane-major."""
    Us, *rest = inputs
    return [torch.from_numpy(np.ascontiguousarray(Us.transpose(0, 2, 1)))] + [
        torch.from_numpy(np.array(a)) for a in rest]


def xla_formulas(Us, VTs, delta_x, delta_gx, gx, active, col):
    """``broyden.py:294-312`` as the JAX solver runs them without the kernel."""
    act = active[:, None]
    rhs = jnp.stack([delta_gx, gx], axis=-1)
    VTX = jnp.einsum("bkd,bdr->bkr", VTs, rhs, precision=_PREC)
    UVX = jnp.einsum("bdk,bkr->bdr", Us, VTX, precision=_PREC)
    matvec_dgx = -delta_gx + UVX[..., 0]
    matvec_gx = -gx + UVX[..., 1]
    xTU = jnp.einsum("bd,bdk->bk", delta_x, Us, precision=_PREC)
    vT = -delta_x + jnp.einsum("bk,bkd->bd", xTU, VTs, precision=_PREC)
    denom = jnp.einsum("bd,bd->b", vT, delta_gx)[:, None]
    u = (delta_x - matvec_dgx) / denom
    vT = jnp.where(jnp.isfinite(vT), vT, 0.0)
    u = jnp.where(jnp.isfinite(u), u, 0.0)
    u = jnp.where(act, u, 0.0)
    vT = jnp.where(act, vT, 0.0)
    Us = jax.lax.dynamic_update_index_in_dim(Us, u, col, axis=2)
    VTs = jax.lax.dynamic_update_index_in_dim(VTs, vT, col, axis=1)
    update = -matvec_gx - u * jnp.einsum("bd,bd->b", vT, gx)[:, None]
    return Us, VTs, update


def check_against_jax(fn, D, K, col, B):
    """``fn`` (the port's layout, in place) against the Pallas kernel in
    interpret mode and the XLA formulas, at atol 1e-5, with the scrub and
    the inactive rows."""
    inputs = make_inputs(D, K, col, seed=D * 100 + K + col, B=B)
    UTs, VTs, *rest = to_port(inputs)
    update = fn(UTs, VTs, *rest, col)  # writes col in place
    got = (UTs.numpy().transpose(0, 2, 1), VTs.numpy(), update.numpy())
    jin = [jnp.asarray(a) for a in inputs]
    for name, ref in (("pallas", fused_broyden_update(*jin, col, interpret=True)),
                      ("xla", xla_formulas(*jin, col))):
        for g, r, what in zip(got, ref, ("Us", "VTs", "update")):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5,
                                       err_msg=f"{what} vs {name}")
    # the scrub: no non-finite value survives; the masked rows add nothing
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    inactive = inactive_rows(B)
    for b in inactive + (ZERO_DENOM,):
        assert not got[0][b, :, col].any(), b
    for b in inactive:
        assert not got[1][b, col].any(), b
        # an inactive row's direction is -matvec(U, V, gx) of the old planes
        np.testing.assert_allclose(got[2][b], np.asarray(ref[2])[b], rtol=0, atol=1e-5)
    # the planes after col stay zero
    assert not got[0][:, :, col + 1:].any() and not got[1][:, col + 1:].any()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_update_matches_jax(case):
    check_against_jax(broyden_update_plain, *CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_update_matches_jax(case):
    """The kernel's order of sums (its form at this D: the warp form's tree
    at D <= 128, the cluster's above) against JAX, as the plain version."""
    check_against_jax(broyden_update_tiled, *CASES[case])


@pytest.mark.parametrize("D", [63, 3072])
def test_plane_major_transposition_is_exact(D):
    """U plane-major at the JAX boundary: the port's planes, transposed back,
    are the JAX kernel's columns bit for bit wherever the update writes
    nothing, and its plane col is JAX's column col."""
    K, col, B = 30, 10, 4
    inputs = make_inputs(D, K, col, seed=7, B=B)
    UTs, VTs, *rest = to_port(inputs)
    assert np.array_equal(UTs.numpy().transpose(0, 2, 1), inputs[0])
    broyden_update_plain(UTs, VTs, *rest, col)
    us_j, vts_j, _ = fused_broyden_update(*[jnp.asarray(a) for a in inputs], col,
                                          interpret=True)
    back, us_j = UTs.numpy().transpose(0, 2, 1), np.asarray(us_j)
    keep = [k for k in range(K) if k != col]
    assert np.array_equal(back[:, :, keep], us_j[:, :, keep])
    assert np.array_equal(VTs.numpy()[:, keep], np.asarray(vts_j)[:, keep])
    np.testing.assert_allclose(back[:, :, col], us_j[:, :, col], rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", [6, 3072])
def test_exact_sums_bracket_the_plain_version(D):
    """The float64-summed model and the tiled model each within 1e-5 of the
    plain version: the floor that chip_smoke.py reads before it holds the
    kernel at UPDATE_TOL 1e-5."""
    inputs = to_port(make_inputs(D, 30, 29, seed=D, B=4))
    outs = {}
    for name, fn in (("plain", broyden_update_plain), ("exact", broyden_update_exact),
                     ("tiled", broyden_update_tiled)):
        UTs, VTs, *rest = [t.clone() for t in inputs]
        outs[name] = (UTs, VTs, fn(UTs, VTs, *rest, 29))
    for name in ("exact", "tiled"):
        for a, b in zip(outs[name], outs["plain"]):
            assert float((a - b).abs().max()) <= 1e-5, name


def test_update_plan_forms():
    """The warp form up to D 128, the cluster form above; at D 3072 (B 64:
    512 CTAs for 132 SMs) 8 CTAs of 96 threads; past the registers the
    stream kernel; every plan covers its D."""
    assert bu.update_plan(6) == bu.UpdatePlan(0, 0, 128, 1)
    assert bu.update_plan(63) == bu.UpdatePlan(0, 0, 128, 2)
    assert bu.update_plan(3072) == bu.UpdatePlan(8, 96, 96, 1)
    assert bu.update_plan(1024) == bu.UpdatePlan(8, 32, 32, 1)
    assert bu.update_plan(40000) == bu.UpdatePlan(8, 1250, 256, 5)  # the stream kernel
    for D in list(range(1, 300)) + [784, 1027, 4097, 12288, bu.REG_MAX_D, bu.REG_MAX_D + 1,
                                    10 ** 6 + 3]:
        p = bu.update_plan(D)
        if p.cluster == 0:
            assert D <= 32 * p.vpt <= bu.WARP_MAX_D
        else:
            assert D > bu.WARP_MAX_D and 4 * p.cluster * p.slice >= D
            assert 4 * (p.cluster - 1) * p.slice < D  # no CTA past the row
            assert p.threads % 32 == 0 and p.threads <= bu.MAX_THREADS
            assert p.vpt * p.threads >= p.slice
            assert (p.vpt in bu.VPT) == (D <= bu.REG_MAX_D)
    with pytest.raises(ValueError):
        bu.update_plan(0)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    inputs = make_inputs(6, 4, 2, seed=0)
    a, b = to_port(inputs), to_port(inputs)
    before = broyden_update.launches
    ua = broyden_update(*a, 2)
    ub = broyden_update_plain(*b, 2)
    assert broyden_update.launches == before  # no kernel launch on the CPU
    for x, y in zip([a[0], a[1], ua], [b[0], b[1], ub]):
        assert torch.equal(x, y)
