"""The port's fused Broyden solve (plain PyTorch version, CPU) against the JAX
package's Pallas kernel in interpret mode, on the same nets and inputs.

Tolerances are those of ``tests/test_fused_solve.py``: rtol 1e-4 / atol 1e-5
on the root and the residual (float sums in another order), per-example
nstep within +-1, converged and protective-break flags equal.
"""
import jax
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers.implicit_block import ImplicitBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_tpu.ops.broyden import \
    fixed_point_iteration as jax_fixed_point_iteration
from implicit_normalizing_flows_tpu.ops.broyden import \
    triage_metrics as jax_triage_metrics
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import broyden as tbr
from implicit_normalizing_flows_torch.ops import fused_solve as tfs

KW = dict(threshold=30, eps=1e-6, stall_patience=5, stall_rtol=0.05,
          stall_guard=3.0)


@pytest.fixture(scope="module")
def nets():
    """Small recipe-shaped block (idim 16, 3x8x8, batch 2), JAX-initialised:
    the inputs and the conv_forward_data dicts of both nets, as numpy."""
    def make_net():
        return build_conv_net((3, 8, 8), 16, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3,
                              3, "swish", preact=True, dropout=0.0, sn_atol=None,
                              sn_rtol=None, learn_p=False, first_resblock=False)

    block = ImplicitBlock(make_net(), make_net(), n_dist="poisson")
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(1), jax.numpy.asarray(x))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    to_np = lambda d: {k: (np.asarray(a) if k != "preact" else a) for k, a in d.items()}
    return (x, to_np(block.nnet_x.conv_forward_data(sub("nnet_x"))),
            to_np(block.nnet_z.conv_forward_data(sub("nnet_z"))))


def _torch(d):
    return {k: (torch.from_numpy(np.array(a)) if k != "preact" else a)
            for k, a in d.items()}


def _both(x, dx, dz, reps, **kw):
    ref = jfs.fused_broyden_solve(jax.numpy.asarray(x), dx, dz, interpret=True,
                                  secant_refs=True, reps=reps, **kw)
    got = tfs.fused_broyden_solve_plain(torch.from_numpy(x), _torch(dx),
                                        _torch(dz), **kw)
    return ref, got


def _assert_match(ref, got):
    np.testing.assert_allclose(got.result.numpy(), np.asarray(ref.result),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.gx.numpy(), np.asarray(ref.gx),
                               rtol=1e-4, atol=1e-5)
    assert np.all(np.abs(got.nstep.numpy() - np.asarray(ref.nstep)) <= 1)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.prot_break.numpy(), np.asarray(ref.prot_break))


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("mode", ["f32", "tf32", "tf32x"])
def test_plain_solve_matches_jax_kernel(nets, mode, ladder, warm_start, reps):
    x, dx, dz = nets
    kw = dict(KW, mode=mode, warm_start=warm_start, newton_init=True)
    if ladder:
        # phase 1 capped at 2 iterations so every example is re-armed at
        # tf32x and then f32 (starts (2, 16))
        kw.update(tail_mode=("tf32x", "f32"), tail_start=2)
    ref, got = _both(x, dx, dz, reps, **kw)
    _assert_match(ref, got)
    assert got.converged.all()


def test_plain_solve_protective_break_matches_jax_kernel(nets):
    """An expansive residual net (w2, w3 scaled 20x) diverges: both solves
    flag the protective break on every row and return the same best
    iterate."""
    x, dx, dz = nets
    dz = dict(dz, w2=dz["w2"] * 20.0, w3=dz["w3"] * 20.0)
    ref, got = _both(x, dx, dz, 1, **dict(KW, mode="f32", newton_init=False))
    assert got.prot_break.all()
    _assert_match(ref, got)


def test_norm_ladder_matches_jax():
    for args in [(30, "tf32x,f32", None), (30, "f32", None), (30, None, None),
                 (30, ("tf32x", "f32"), 2), (30, ("tf32x", "f32"), (10, 20))]:
        assert tfs.norm_ladder(*args) == jfs._norm_ladder(*args)


def test_cuda_wrappers_refuse_cpu_operands_without_falling_back():
    """A CPU tensor takes the plain version; the kernel path checks its
    operands and raises instead of falling back."""
    t = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfs._check_cuda(t=t)


def test_fixed_point_iteration_matches_jax():
    """The Banach fallback of protective-break rows: same iterates and the
    same per-row stop as the JAX package, on a contraction whose rows
    converge at different iterations."""
    rng = np.random.RandomState(4)
    y = rng.standard_normal((3, 40)).astype(np.float32)
    A = (rng.standard_normal((40, 40)) * 0.08).astype(np.float32)
    damp = np.array([[0.2], [0.6], [0.9]], np.float32)
    ref = jax_fixed_point_iteration(
        lambda x: jax.numpy.tanh(x @ A) * damp + y, jax.numpy.asarray(y),
        threshold=1000, eps=1e-6)
    got = tbr.fixed_point_iteration(
        lambda x: torch.tanh(x @ torch.from_numpy(A)) * torch.from_numpy(damp)
        + torch.from_numpy(y), torch.from_numpy(y), threshold=1000, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_triage_metrics_matches_jax():
    for m in [{"broyden_prot_break": 0.0},
              {"broyden_prot_break": 1.0, "broyden_nstep": 12.5,
               "broyden_converged": 0.75}]:
        assert tbr.triage_metrics(m) == jax_triage_metrics(m)
