"""The port's estimator final pair, plain PyTorch version on the CPU, against
the JAX package's ``fused_final_pair`` (Pallas primal and hand-derived
second-order backward in interpret mode), on the same ``conv_forward_data``
of both nets (a JAX block of idim 16 at c x 8 x 8, batch 2, with and
without preact), the same x, z, probes, accumulations and per-example
cotangents of (T_x, T_z).

Compared: T_x, T_z and every gradient, to x, z and both nets' effective
kernels, biases and swish slopes. Mode f32 at JAX's own tolerances for this
kernel (``tests/test_fused_solve.py:230-236``): values rtol 1e-5, gradients
rtol 5e-4 / atol 1e-5. Mode bf16 rounds every product's operands as JAX
does and sums the exact products in float32 in another order; there each
output is held by ``rel_norm`` at 2e-5 (measured here: at most 5.6e-7), and
the control, the port's pair in mode f32 on the same inputs, reads 7.4e-4
or more on every output that a product reaches and must lie above it.

Also, in float64: the hand-derived backward equals autograd's double
backward of ``<J^T acc, eps>`` (the definition the kernels implement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops.fused_solve import swish

from test_torch_backward_solve import make_blocks, rel_norm

NAMES = ("w1", "w2", "w3", "b1", "b2", "b3", "betas")
ROUNDED_TOL = 2e-5
# b3's gradient is exactly zero on both sides
UNROUNDED = ("x.b3", "z.b3")


def _inputs(c, preact):
    jblock, v, block, x = make_blocks(c, 8, preact)
    rng = np.random.RandomState(5)
    f32 = lambda a: np.asarray(a, np.float32)
    z = f32(x + 0.2 * rng.standard_normal(x.shape))
    eps_x, eps_z = (f32(rng.choice([-1.0, 1.0], size=x.shape)) for _ in range(2))
    acc_x, acc_z = (f32(rng.standard_normal(x.shape)) for _ in range(2))
    cot = f32(rng.standard_normal((2, x.shape[0])))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    dx = jblock.nnet_x.conv_forward_data(sub("nnet_x"))
    dz = jblock.nnet_z.conv_forward_data(sub("nnet_z"))
    return dx, dz, (x, z, eps_x, eps_z, acc_x, acc_z), cot


def _jax(dx, dz, arrays, cot, mode):
    """(T_x, T_z) and the gradients [d_x, d_z, x.*, z.*] of <cot, T>."""
    strip = lambda d: {k: jnp.asarray(a) for k, a in d.items() if k != "preact"}
    x, z, ex, ez, ax, az = (jnp.asarray(a) for a in arrays)

    def f(dsx, dsz, xx, zz):
        return jfs.fused_final_pair(dict(dsx, preact=dx["preact"]),
                                    dict(dsz, preact=dz["preact"]), xx, zz, ex, ez,
                                    ax, az, mode=mode, interpret=True, reps=1)

    with jax.disable_jit(mode != "f32"):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        T, vjp = jax.vjp(f, strip(dx), strip(dz), x, z)
        gdx, gdz, gx, gz = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    grads = [gx, gz] + [gdx[k] for k in NAMES] + [gdz[k] for k in NAMES]
    return [np.asarray(t) for t in T], [np.asarray(g) for g in grads]


def _torch(dx, dz, arrays, cot, mode, dtype=torch.float32):
    """The port's (T_x, T_z) and gradients in the order of :func:`_jax`."""
    td = lambda d: {k: (torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True)
                        if k != "preact" else a) for k, a in d.items()}
    dx, dz = td(dx), td(dz)
    x, z, ex, ez, ax, az = (torch.from_numpy(a).to(dtype) for a in arrays)
    x.requires_grad_(True)
    z.requires_grad_(True)
    T = ff.fused_final_pair_plain(dx, dz, x, z, ex, ez, ax, az, mode=mode)
    c = torch.from_numpy(cot).to(dtype)
    leaves = [x, z] + [dx[k] for k in NAMES] + [dz[k] for k in NAMES]
    grads = torch.autograd.grad((T[0] * c[0]).sum() + (T[1] * c[1]).sum(), leaves)
    return [t.detach() for t in T], list(grads), (dx, dz, x, z, ex, ez, ax, az)


LABELS = ["d_x", "d_z"] + [f"x.{k}" for k in NAMES] + [f"z.{k}" for k in NAMES]


@pytest.mark.parametrize("c,preact,mode", [
    (3, True, "f32"), (3, False, "f32"), (12, True, "f32"),
    (3, True, "bf16"), (12, False, "bf16"),
])
def test_final_pair_matches_jax(c, preact, mode):
    dx, dz, arrays, cot = _inputs(c, preact)
    T_ref, g_ref = _jax(dx, dz, arrays, cot, mode)
    T_got, g_got, _ = _torch(dx, dz, arrays, cot, mode)
    control = None if mode == "f32" else _torch(dx, dz, arrays, cot, "f32")
    for i, (t, r) in enumerate(zip(T_got, T_ref)):
        assert t.shape == r.shape
        if mode == "f32":
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-5, err_msg=f"T{i}")
        else:
            assert rel_norm(t.numpy(), r) <= ROUNDED_TOL, (i, rel_norm(t.numpy(), r))
            ctrl = rel_norm(control[0][i].numpy(), r)
            assert ctrl > ROUNDED_TOL, (i, ctrl)
    for i, (name, g, r) in enumerate(zip(LABELS, g_got, g_ref)):
        g = g.numpy()
        assert g.shape == r.shape, name
        if mode == "f32":
            np.testing.assert_allclose(g, r, rtol=5e-4, atol=1e-5, err_msg=name)
            continue
        assert rel_norm(g, r) <= ROUNDED_TOL, (name, rel_norm(g, r))
        if name not in UNROUNDED:
            ctrl = rel_norm(control[1][i].numpy(), r)
            assert ctrl > ROUNDED_TOL, (name, ctrl)
    if not preact:
        assert float(g_got[2 + 6][0]) == 0.0 and float(g_got[2 + 7 + 6][0]) == 0.0
    assert float(g_got[2 + 5].abs().max()) == 0.0  # b3


@pytest.mark.parametrize("preact", [True, False])
def test_final_pair_is_the_double_backward(preact):
    """In float64 the plain pair (mode f32 arithmetic on float64 tensors)
    equals <J^T acc, eps> through torch.autograd, its value and its
    gradients w.r.t. x, z and the effective tensors (autograd's double
    backward)."""
    dx, dz, arrays, cot = _inputs(3, preact)
    T_got, g_got, (tdx, tdz, x, z, ex, ez, ax, az) = _torch(
        dx, dz, arrays, cot, "f32", dtype=torch.float64)
    F = torch.nn.functional

    def net(h, d):
        b = d["betas"]
        a0 = swish(h, b[0]) if d["preact"] else h
        h1 = F.conv2d(a0, d["w1"], d["b1"], padding=1)
        h2 = F.conv2d(swish(h1, b[1]), d["w2"], d["b2"])
        return F.conv2d(swish(h2, b[2]), d["w3"], d["b3"], padding=1)

    def T(h, d, e, acc):
        vjp = torch.autograd.grad(net(h, d), h, acc, create_graph=True)[0]
        return (vjp * e).sum((1, 2, 3))

    want_T = [T(x, tdx, ex, ax), T(z, tdz, ez, az)]
    c = torch.from_numpy(cot).double()
    leaves = [x, z] + [tdx[k] for k in NAMES] + [tdz[k] for k in NAMES]
    want = torch.autograd.grad((want_T[0] * c[0]).sum() + (want_T[1] * c[1]).sum(),
                               leaves, allow_unused=True)
    for t, w in zip(T_got, want_T):
        torch.testing.assert_close(t, w.detach(), rtol=1e-10, atol=1e-10)
    for name, g, w in zip(LABELS, g_got, want):
        w = torch.zeros_like(g) if w is None else w  # b3 does not reach T
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("bin_,shift", [("dswish", True), ("swish", False),
                                        ("id", True)])
def test_wgrad_splits_sum_to_the_product(bin_, shift):
    """The final pair's weight-gradient products (A as it is, B
    pre-activated, shifted or not) through rv_wgrad's split-K partials +
    rv_wgrad_reduce equal the whole product, for a batch x pixels axis cut
    into several splits."""
    g = torch.Generator().manual_seed(6)
    Bn, M, Cb, H, W = 8, 16, 3, 8, 8
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    a, b, bh = r(Bn, M, H * W), r(Bn, Cb, H, W), r(Bn, Cb, H, W)
    beta = torch.tensor(0.7, dtype=torch.float64)
    N = Cb * 9 if shift else Cb
    splits, _ = ig.wgrad_splits(M, N, Bn, H * W)
    assert splits > 1
    part = torch.empty(splits, M, N, dtype=torch.float64)
    ig.rv_wgrad(a, None, None, b, bh, beta, bin_, shift, "f32", part, H, W)
    out = torch.empty(M, N, dtype=torch.float64)
    ig.rv_wgrad_reduce(part, 1.0, out)
    A, Bm = ig._wgrad_operands(a, None, None, b, bh, beta, bin_, shift, H, W)
    torch.testing.assert_close(out, A @ Bm.T, rtol=1e-12, atol=1e-12)
