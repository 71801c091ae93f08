"""The port's backward (implicit-gradient) solve, plain PyTorch version on the
CPU, against the JAX package's ``fused_backward_solve`` Pallas kernel in
interpret mode, on the same linearisation data.

The chain data (s0, s1, s2, w1, w2, w3) comes from the JAX net at a random z
and is handed to both solves; ``conv_chain_data`` of the port's net (same
weights) is held against the JAX one on its own.

Tolerances: mode f32 at rtol 1e-4 / atol 1e-5 (float sums in another order
over at most 8 Broyden iterations of a linear solve). Mode bf16 by
``rel_norm(u, ref, grad)``, the error over the norm of the part the J^T
products make, at 1e-3 (measured here: 3.3e-6 to 3.9e-4, the largest at
threshold 8): both sides round the same operands to bfloat16 and sum their
exact products in float32 in another order, so an iterate one float32 ulp
apart rounds to another bfloat16 at a few ties. The control, the port's
solve in mode f32 on the same data, reads 2.9e-3 to 4.7e-3 and must lie
above the limit: a solve that skipped the bf16 rounding fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers.implicit_block import \
    ImplicitBlock as JBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import \
    build_conv_net as jax_build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.layers import ImplicitBlock
from implicit_normalizing_flows_torch.models import build_conv_net
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.training import jax_variables_to_torch

KW = dict(eps=1e-10, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
          newton_init=True)
BF16_TOL = 1e-3


def rel_norm(a, b, base=None):
    """||a - b|| over ||b - base|| in float64 (numpy or torch inputs)."""
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    ref = b if base is None else b - np.asarray(base, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-300))


def make_blocks(c, hw, preact, seed=1, B=2):
    """A JAX ImplicitBlock (idim 16, c x hw x hw), its variables, and the
    port's block with the same weights; ``preact`` False is the first block
    of a scale. Returns (jblock, variables, block, x) with x (B, c, hw, hw)
    numpy."""
    def jnet():
        return jax_build_conv_net((c, hw, hw), 16, "3-1-3", 0.9, [2.0] * 3,
                                  [2.0] * 3, 3, "swish", preact=preact,
                                  dropout=0.0, sn_atol=None, sn_rtol=None,
                                  learn_p=False, first_resblock=not preact)

    def tnet():
        return build_conv_net((c, hw, hw), 16, "3-1-3", 0.9, 3, preact, None,
                              None, first_resblock=not preact, device="cpu")

    jblock = JBlock(jnet(), jnet(), n_dist="poisson", n_exact_terms=2,
                    grad_in_forward=True)
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, c, hw, hw)) * 0.5).astype(np.float32)
    v = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    block = ImplicitBlock(tnet(), tnet(), n_dist="poisson", device="cpu")
    params, state = (jax.tree.map(np.asarray, v[k]) for k in ("params", "state"))
    block.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    return jblock, v, block, x


def jax_chain_data(jblock, v, z, mode):
    """conv_chain_data of JAX's net z as its backward solve takes it
    (``implicit_block.py:356-378``): bf16 casts of every variable and of z
    in mode bf16."""
    vz = {"params": v["params"]["nnet_z"], "state": v["state"]["nnet_z"]}
    z = jnp.asarray(z)
    if mode == "bf16":
        vz = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 else a, vz)
        z = z.astype(jnp.bfloat16)
    return jblock.nnet_z.conv_chain_data(vz, z)


def to_torch(cd):
    return tuple(torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32) for a in cd)


def run_both(cd, grad, threshold, mode):
    with jax.disable_jit(mode == "bf16"):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = jfs.fused_backward_solve(jnp.asarray(grad), cd, threshold=threshold,
                                       mode=mode, interpret=True, reps=1, **KW)
    got = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd),
                                        threshold=threshold, mode=mode, **KW)
    return np.asarray(ref), got


CASES = [(c, hw, preact, threshold, "f32") for c in (3, 12) for hw in (8, 16)
         for preact in (True, False) for threshold in (4, 8)]
CASES += [(3, 16, True, 4, "bf16"), (12, 8, False, 4, "bf16"),
          (3, 8, False, 8, "bf16"), (12, 16, True, 8, "bf16")]


@pytest.mark.parametrize("c,hw,preact,threshold,mode", CASES)
def test_backward_solve_matches_jax(c, hw, preact, threshold, mode):
    jblock, v, block, x = make_blocks(c, hw, preact)
    rng = np.random.RandomState(2)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, mode)

    # the port's linearisation of the same net at the same point
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    mine = block.nnet_z.conv_chain_data(torch.from_numpy(z), dtype)
    for name, a, b in zip(("s0", "s1", "s2", "w1", "w2", "w3"), mine, to_torch(cd)):
        assert a.dtype == b.dtype, name
        tol = dict(rtol=1e-5, atol=1e-6) if mode == "f32" else dict(rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(a.float(), b.float(), **tol, msg=name)

    ref, got = run_both(cd, grad, threshold, mode)
    assert got.u.shape == grad.shape and bool(torch.isfinite(got.u).all())
    assert int(got.nstep.max()) == threshold  # eps 1e-10: the whole budget
    assert not bool(got.prot_break.any())
    if mode == "f32":
        np.testing.assert_allclose(got.u.numpy(), ref, rtol=1e-4, atol=1e-5)
    else:
        err = rel_norm(got.u.numpy(), ref, grad)
        control = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd),
                                                threshold=threshold, mode="f32", **KW)
        ctrl = rel_norm(control.u.numpy(), ref, grad)
        assert err <= BF16_TOL < ctrl, (err, ctrl)


def test_backward_solve_protective_break():
    """Example 0 has J = 0 (s = 0): Broyden reaches u = grad. Example 1's
    J^T is scaled by 1e9: the first step overshoots past 1e6 x the initial
    residual, the protective break fires after one step and the best
    iterate (the zero init) is returned."""
    jblock, v, block, x = make_blocks(3, 8, True)
    cd = [np.asarray(a) for a in jax_chain_data(jblock, v, x, "f32")]
    s0, s1, s2, w1, w2, w3 = cd
    s0, s1, s2 = (np.concatenate([np.zeros_like(s[:1]), s[1:]]) for s in (s0, s1, s2))
    cd = (s0, s1, s2, w1 * 1e3, w2 * 1e3, w3 * 1e3)
    grad = np.random.RandomState(3).standard_normal(x.shape).astype(np.float32)
    ref, got = run_both(tuple(jnp.asarray(a) for a in cd), grad, 4, "f32")
    assert got.prot_break.tolist() == [False, True]
    assert got.nstep.tolist() == [4, 1]
    np.testing.assert_allclose(got.u.numpy(), ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.u[0].numpy(), grad[0], rtol=1e-5, atol=1e-5)
    assert float(got.u[1].abs().max()) == 0.0


def test_transpose_weights_are_the_adjoint():
    """<C w, a> = <b, C^T w a>: the flipped/transposed kernels are the
    convs' adjoints."""
    g = torch.Generator().manual_seed(0)
    w1, w2, w3 = (torch.randn(s, generator=g, dtype=torch.float64)
                  for s in ((16, 3, 3, 3), (16, 16, 1, 1), (3, 16, 3, 3)))
    w3t, w2t, w1t = ig.transpose_weights(w1, w2, w3)
    conv = torch.nn.functional.conv2d
    for w, wt, cin, cout, pad in ((w1, w1t, 3, 16, 1), (w2, w2t, 16, 16, 0),
                                  (w3, w3t, 16, 3, 1)):
        a = torch.randn(2, cin, 5, 5, generator=g, dtype=torch.float64)
        b = torch.randn(2, cout, 5, 5, generator=g, dtype=torch.float64)
        lhs = torch.sum(conv(a, w, padding=pad) * b)
        rhs = torch.sum(a * conv(b, wt, padding=pad))
        torch.testing.assert_close(lhs, rhs)

