"""The port's fused Neumann chain, plain PyTorch version on the CPU, against
the JAX package's ``fused_neumann_chain2`` Pallas kernel and its one-net
twin ``fused_neumann_chain`` in interpret mode,
on the same numpy-seeded probes, derivative factors and kernels of two nets
(c 3 or 12, mid 16, 8x8, batch 2; s0 ones without preact, a sigmoid with
it; signed roulette coefficients, n_power 1, 4 and the cap 6).

Tolerances: float32 at rtol 1e-5, JAX's own for this kernel
(``tests/test_fused_chain.py:179``), with atol 1e-6 for the few entries
that cancel to near zero (the entries are of order 1; measured here: at
most 4.9e-7 apart where rtol alone does not cover them): the same products
summed in another order. bfloat16 (the training default): every stage
output and every product's operand is rounded to bfloat16 on both sides,
the sums are float32, so an output one float32 ulp apart rounds to another
bfloat16 at a few ties; each acc is held by ``rel_norm`` over the part the
J^T terms make (acc - eps) at 1e-4 (measured here: at most 5.9e-6), and the
control, the port's chain in float32 on the same bfloat16 values, reads
2.6e-3 or more and must lie above it: a chain that skipped the rounding
fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_chain as jfc
from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_torch.ops import fused_chain as fc
from implicit_normalizing_flows_torch.ops import logdet as ld

from test_torch_backward_solve import rel_norm

B, MID, HW, CAP = 2, 16, 8, 6
BF16_TOL = 1e-4


def make_chain(c, preact, seed):
    """(eps, s0, s1, s2, w1, w2, w3) numpy float32 of one net."""
    rng = np.random.RandomState(seed)
    sig = lambda *s: 1.0 / (1.0 + np.exp(-rng.standard_normal(s)))
    eps = rng.choice([-1.0, 1.0], size=(B, c, HW, HW))
    s0 = sig(B, c, HW, HW) if preact else np.ones((B, c, HW, HW))
    s1, s2 = sig(B, MID, HW, HW), sig(B, MID, HW, HW)
    w1 = rng.standard_normal((MID, c, 3, 3)) * 0.2
    w2 = rng.standard_normal((MID, MID, 1, 1)) * 0.1
    w3 = rng.standard_normal((c, MID, 3, 3)) * 0.2
    return [a.astype(np.float32) for a in (eps, s0, s1, s2, w1, w2, w3)]


def signed_coeffs():
    ks = np.arange(1, CAP + 1)
    return (np.where(ks % 2 == 0, 1.0, -1.0) * np.linspace(1.0, 0.3, CAP)).astype(np.float32)


def jax_chain2(cx, cz, n_power, dtype):
    """JAX's fused_neumann_chain2 in interpret mode on its im2col layouts."""
    c = cx[0].shape[1]
    c8 = max(8, -(-c // 8) * 8)

    def prep(ch):
        eps, s0, s1, s2, w1, w2, w3 = (jnp.asarray(a).astype(dtype) for a in ch)
        pad = lambda a: jnp.pad(a, ((0, 0), (0, c8 - c), (0, 0), (0, 0)))
        flat = lambda a: a.reshape(B, a.shape[1], HW * HW)
        return (flat(pad(eps)), flat(pad(s0)), flat(s1), flat(s2),
                jfc.conv3_transpose_mats(w3, c8), jfc.conv1x1_transpose_mat(w2),
                jfc.conv3_transpose_mats_cout(w1, c8))

    with jax.disable_jit(dtype == jnp.bfloat16):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ax, az = jfc.fused_neumann_chain2(prep(cx), prep(cz), jnp.asarray(signed_coeffs()),
                                          jnp.asarray(n_power), H=HW, W=HW, interpret=True)
    unpad = lambda a: np.asarray(a)[:, :c].reshape(B, c, HW, HW)
    return unpad(ax), unpad(az)


def jax_chain(ch, n_power, dtype):
    """JAX's one-net fused_neumann_chain in interpret mode."""
    c = ch[0].shape[1]
    c8 = max(8, -(-c // 8) * 8)
    eps, s0, s1, s2, w1, w2, w3 = (jnp.asarray(a).astype(dtype) for a in ch)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, c8 - c), (0, 0), (0, 0)))
    flat = lambda a: a.reshape(B, a.shape[1], HW * HW)
    with jax.disable_jit(dtype == jnp.bfloat16):
        acc = jfc.fused_neumann_chain(
            flat(pad(eps)), flat(pad(s0)), flat(s1), flat(s2), jfc.conv3_transpose_mats(w3, c8),
            jfc.conv1x1_transpose_mat(w2), jfc.conv3_transpose_mats_cout(w1, c8),
            jnp.asarray(signed_coeffs()), jnp.asarray(n_power), H=HW, W=HW, interpret=True)
    return np.asarray(acc)[:, :c].reshape(B, c, HW, HW)


def torch_chain(ch, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in ch)


CASES = [(3, True, 1, "f32"), (3, False, 4, "f32"), (12, True, CAP, "f32"),
         (12, False, CAP, "f32"), (3, True, 4, "bf16"), (12, False, CAP, "bf16"),
         (12, True, 1, "bf16")]


@pytest.mark.parametrize("c,preact,n_power,mode", CASES)
def test_neumann_chain2_matches_jax(c, preact, n_power, mode):
    cx, cz = make_chain(c, preact, 1), make_chain(c, preact, 2)
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    if mode == "bf16":  # the same bfloat16 values on both sides
        cx, cz = ([t.float().numpy() for t in torch_chain(ch, tdt)] for ch in (cx, cz))
    ref = jax_chain2(cx, cz, n_power, jnp.bfloat16 if mode == "bf16" else jnp.float32)
    got = fc.fused_neumann_chain2_plain(torch_chain(cx, tdt), torch_chain(cz, tdt),
                                        torch.from_numpy(signed_coeffs()), n_power)
    for g, r, eps in zip(got, ref, (cx[0], cz[0])):
        assert g.dtype == torch.float32 and g.shape == r.shape
        if mode == "f32":
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)
            continue
        err = rel_norm(g.numpy(), r, eps)
        control = fc.fused_neumann_chain2_plain(
            torch_chain(cx, torch.float32), torch_chain(cz, torch.float32),
            torch.from_numpy(signed_coeffs()), n_power)
        ctrl = min(rel_norm(a.numpy(), b, e) for a, b, e in zip(control, ref, (cx[0], cz[0])))
        assert err <= BF16_TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("c,preact,n_power,mode", [(3, True, 4, "f32"), (12, False, CAP, "f32"),
                                                    (3, True, 4, "bf16"), (12, True, 1, "bf16")])
def test_neumann_chain_one_net_matches_jax(c, preact, n_power, mode):
    """The one-net chain (``fused_neumann_chain``, the row-2 kernels
    launched on one net) against JAX's, at the tolerances above."""
    ch = make_chain(c, preact, 7)
    tdt = torch.bfloat16 if mode == "bf16" else torch.float32
    if mode == "bf16":
        ch = [t.float().numpy() for t in torch_chain(ch, tdt)]
    ref = jax_chain(ch, n_power, jnp.bfloat16 if mode == "bf16" else jnp.float32)
    got = fc.fused_neumann_chain_plain(torch_chain(ch, tdt), torch.from_numpy(signed_coeffs()),
                                       n_power)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if mode == "f32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
        return
    err = rel_norm(got.numpy(), ref, ch[0])
    ctrl = rel_norm(fc.fused_neumann_chain_plain(torch_chain(ch, torch.float32),
                                                 torch.from_numpy(signed_coeffs()),
                                                 n_power).numpy(), ref, ch[0])
    assert err <= BF16_TOL < ctrl, (err, ctrl)
    # the one-net chain is the two-net chain's first net
    pair = fc.fused_neumann_chain2_plain(torch_chain(ch, tdt), torch_chain(ch, tdt),
                                         torch.from_numpy(signed_coeffs()), n_power)
    torch.testing.assert_close(got, pair[0], rtol=0, atol=0)


def test_neumann_pair_accs_matches_jax():
    """The port's ``neumann_pair_accs`` (unsigned roulette coefficients,
    the (-1)^k folded in, the chain data as ``conv_chain_data`` returns it)
    against JAX's, float32."""
    c, n_power = 3, 5
    cx, cz = make_chain(c, True, 3), make_chain(c, True, 4)
    coeffs = np.linspace(1.0, 0.3, CAP).astype(np.float32)
    jx = [jnp.asarray(a) for a in cx]
    jz = [jnp.asarray(a) for a in cz]
    ref = jld.neumann_pair_accs(jx[0], jx[0], jz[0], jz[0], jx[1:], jz[1:],
                                jnp.asarray(coeffs), jnp.asarray(n_power),
                                interpret=True, reps=1)
    tx, tz = torch_chain(cx, torch.float32), torch_chain(cz, torch.float32)
    got = ld.neumann_pair_accs(tx[0], tx[1:], tz[0], tz[1:], torch.from_numpy(coeffs),
                               n_power)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_neumann_chain_is_the_series():
    """In float64, acc = eps + sum_k c_k (J^T)^k eps with J^T applied as
    torch.autograd's VJP of the net linearised by s0/s1/s2."""
    cx, cz = make_chain(3, True, 5), make_chain(3, True, 6)
    F = torch.nn.functional
    got = fc.fused_neumann_chain2_plain(torch_chain(cx, torch.float64),
                                        torch_chain(cz, torch.float64),
                                        torch.from_numpy(signed_coeffs()).double(), CAP)
    for ch, g in zip((cx, cz), got):
        eps, s0, s1, s2, w1, w2, w3 = torch_chain(ch, torch.float64)

        def lin(v):  # J v of the linearised net
            return F.conv2d(s2 * F.conv2d(s1 * F.conv2d(s0 * v, w1, padding=1), w2), w3,
                            padding=1)

        u, acc = eps, eps.clone()
        for k in range(CAP):
            v = u.clone().requires_grad_(True)
            u = torch.autograd.grad(lin(v), v, u)[0]
            acc = acc + float(signed_coeffs()[k]) * u
        torch.testing.assert_close(g.double(), acc, rtol=1e-10, atol=1e-10)
