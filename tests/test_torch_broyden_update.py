"""The generic Broyden solver's rank-1 secant update: the port's plain version
(what ``broyden_update`` runs for CPU tensors, and what ``chip_smoke.py``
holds the CUDA kernel against on the card) against the JAX package's
``fused_broyden_update`` in interpret mode and against the XLA formulas of
its solver (``ops/broyden.py:294-312``), on the same numpy inputs.

Grid: D 6 (POWER) / 63 (BSDS300), K 4 (backward budget) / 30 (forward),
col 0 / K // 2 / K - 1, with the columns ``>= col`` zero as in the solver,
two inactive rows and one zero-denominator row (delta_gx = 0: u is inf or
NaN and scrubbed to 0). Tolerance atol 1e-5: float32 on both sides, only
the summation order differs (the factors are drawn at a solver's scale, so
the values are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.broyden import _PREC
from implicit_normalizing_flows_tpu.ops.pallas_kernels import fused_broyden_update
from implicit_normalizing_flows_torch.ops.broyden_update import (broyden_update,
                                                                  broyden_update_plain)

B = 8
INACTIVE, ZERO_DENOM = (1, 5), 3


def make_inputs(D, K, col, seed):
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
    active[list(INACTIVE)] = False
    return f32(Us), f32(VTs), f32(dx), f32(dgx), f32(gx), active


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


@pytest.mark.parametrize("D", [6, 63])
@pytest.mark.parametrize("K", [4, 30])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_plain_update_matches_jax(D, K, where):
    col = {"first": 0, "mid": K // 2, "last": K - 1}[where]
    inputs = make_inputs(D, K, col, seed=D * 100 + K + col)
    Us, VTs, *rest = [torch.from_numpy(np.array(a)) for a in inputs]
    update = broyden_update_plain(Us, VTs, *rest, col)  # writes col in place
    got = (Us.numpy(), VTs.numpy(), update.numpy())
    jin = [jnp.asarray(a) for a in inputs]
    for name, ref in (("pallas", fused_broyden_update(*jin, col, interpret=True)),
                      ("xla", xla_formulas(*jin, col))):
        for g, r, what in zip(got, ref, ("Us", "VTs", "update")):
            np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5,
                                       err_msg=f"{what} vs {name}")
    # the scrub: no non-finite value survives; the masked rows add nothing
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    for b in INACTIVE + (ZERO_DENOM,):
        assert not got[0][b, :, col].any(), b
    for b in INACTIVE:
        assert not got[1][b, col].any(), b
    # the columns after col stay zero
    assert not got[0][:, :, col + 1:].any() and not got[1][:, col + 1:].any()


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    inputs = make_inputs(6, 4, 2, seed=0)
    a = [torch.from_numpy(np.array(x)) for x in inputs]
    b = [torch.from_numpy(np.array(x)) for x in inputs]
    before = broyden_update.launches
    ua = broyden_update(*a, 2)
    ub = broyden_update_plain(*b, 2)
    assert broyden_update.launches == before  # no kernel launch on the CPU
    for x, y in zip([a[0], a[1], ua], [b[0], b[1], ub]):
        assert torch.equal(x, y)
