"""The port's re-attachment VJP, plain PyTorch version on the CPU, against
the JAX package's ``fused_reattach_vjp`` Pallas kernel in interpret mode, on
the same ``conv_forward_data`` of both nets, the same x, z_hat and u.

Compared: d_x and every gradient of both nets w.r.t. the effective kernels,
biases and swish slopes. Mode f32 at JAX's own tolerance for this kernel
(rtol 5e-4 / atol 1e-5, ``tests/test_fused_solve.py:194``). Modes bf16 and
tf32 round every product's operands as JAX does and sum the exact products
in float32 in another order; there each tensor is held by ``rel_norm``
(for d_x over the norm of d_x - u, the part the products make) at 2e-5
(measured here: 1.1e-6 in bf16, 2.2e-6 in tf32). In bf16 the control, the
port's VJP in mode f32 on the same inputs, reads 8.8e-4 or more on every
tensor that a product reaches and must lie above the limit. In tf32 it
reads 2.8e-6, as close as the two implementations are to each other: the
three-pass split sits within about 2^-16 of float32, which this size
cannot tell from a float32 sum in another order.

Also: the split-K weight gradient sums to the same product whatever the
split, and the whole VJP equals autograd's VJP of the re-attachment map in
float64 (the definition the kernels implement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig

from test_torch_backward_solve import make_blocks, rel_norm

NAMES = ("w1", "w2", "w3", "b1", "b2", "b3", "betas")
ROUNDED_TOL = 2e-5
# the last conv's bias gradient is the sum of the cotangent: no product
UNROUNDED = ("x.b3", "z.b3")


def _inputs(c, hw, preact, B=2):
    jblock, v, block, x = make_blocks(c, hw, preact, B=B)
    rng = np.random.RandomState(4)
    z_hat = (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)
    u = rng.standard_normal(x.shape).astype(np.float32)
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    dx = jblock.nnet_x.conv_forward_data(sub("nnet_x"))
    dz = jblock.nnet_z.conv_forward_data(sub("nnet_z"))
    return x, z_hat, u, dx, dz, block


def _torch(d):
    return {k: (torch.from_numpy(np.array(a)) if k != "preact" else a)
            for k, a in d.items()}


@pytest.mark.parametrize("c,hw,preact,mode", [
    (3, 8, True, "f32"), (3, 8, False, "f32"), (12, 8, True, "f32"),
    (3, 16, True, "bf16"), (12, 8, False, "bf16"), (3, 8, True, "tf32"),
])
def test_reattach_vjp_matches_jax(c, hw, preact, mode):
    x, z_hat, u, dx, dz, _ = _inputs(c, hw, preact)
    with jax.disable_jit(mode != "f32"):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = jfs.fused_reattach_vjp(jnp.asarray(x), jnp.asarray(z_hat),
                                     jnp.asarray(u), dx, dz, mode=mode,
                                     interpret=True, reps=1)
    got = ig.fused_reattach_vjp_plain(torch.from_numpy(x), torch.from_numpy(z_hat),
                                      torch.from_numpy(u), _torch(dx), _torch(dz),
                                      mode=mode)
    control = None if mode == "f32" else ig.fused_reattach_vjp_plain(
        torch.from_numpy(x), torch.from_numpy(z_hat), torch.from_numpy(u), _torch(dx),
        _torch(dz), mode="f32")

    def flat(g):
        return [("d_x", g[0])] + [(f"{n}.{k}", h[k]) for n, h in (("x", g[1]), ("z", g[2]))
                                  for k in NAMES]

    for i, (name, g) in enumerate(flat(got)):
        g, r = g.detach().numpy(), np.asarray(flat(ref)[i][1])
        assert g.shape == r.shape, name
        if mode == "f32":
            np.testing.assert_allclose(g, r, rtol=5e-4, atol=1e-5, err_msg=name)
            continue
        base = u if name == "d_x" else None
        assert rel_norm(g, r, base) <= ROUNDED_TOL, (name, rel_norm(g, r, base))
        if mode == "bf16" and name not in UNROUNDED:
            ctrl = rel_norm(flat(control)[i][1].detach().numpy(), r, base)
            assert ctrl > ROUNDED_TOL, (name, ctrl)
    if not preact:
        assert float(got[1]["betas"][0]) == 0.0 and float(got[2]["betas"][0]) == 0.0


def test_reattach_vjp_is_the_autograd_vjp():
    """In float64, the plain VJP (mode f32 arithmetic on float64 tensors)
    equals torch.autograd's VJP of x + g_x(x) - g_z(z_hat) w.r.t. x and the
    effective tensors."""
    x, z_hat, u, dx, dz, block = _inputs(3, 8, True)
    f64 = lambda d: {k: (v.double().requires_grad_(True) if k != "preact" else v)
                     for k, v in _torch(d).items()}
    dx, dz = f64(dx), f64(dz)
    X = torch.from_numpy(x).double().requires_grad_(True)
    Zh, U = torch.from_numpy(z_hat).double(), torch.from_numpy(u).double()
    F = torch.nn.functional

    def net(h, d):
        b = d["betas"]
        a0 = ig.swish(h, b[0]) if d["preact"] else h
        h1 = F.conv2d(a0, d["w1"], d["b1"], padding=1)
        h2 = F.conv2d(ig.swish(h1, b[1]), d["w2"], d["b2"])
        return F.conv2d(ig.swish(h2, b[2]), d["w3"], d["b3"], padding=1)

    out = X + net(X, dx) - net(Zh, dz)
    leaves = [X] + [dx[k] for k in NAMES] + [dz[k] for k in NAMES]
    want = torch.autograd.grad(out, leaves, U)
    got_dx, gx, gz = ig.fused_reattach_vjp_plain(
        X.detach(), Zh, U, {k: (v.detach() if k != "preact" else v) for k, v in dx.items()},
        {k: (v.detach() if k != "preact" else v) for k, v in dz.items()}, mode="f32")
    got = [got_dx] + [gx[k] for k in NAMES] + [gz[k] for k in NAMES]
    for name, g, w in zip(["d_x"] + [f"x.{k}" for k in NAMES] + [f"z.{k}" for k in NAMES],
                          got, want):
        torch.testing.assert_close(g.double(), w, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("kind", ["w3", "w2", "w1", "w1_preact"])
def test_wgrad_splits_sum_to_the_product(kind):
    """rv_wgrad's split-K partials + rv_wgrad_reduce equal the whole
    product, for a batch x pixels axis cut into several splits."""
    g = torch.Generator().manual_seed(5)
    B, c, mid, H, W = 8, 3, 16, 8, 8
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    shapes = {"w3": ((B, c, H * W), None, (B, mid, H * W), c, mid * 9),
              "w2": ((B, mid, H * W), (B, mid, H * W), (B, mid, H * W), mid, mid),
              "w1": ((B, mid, H * W), (B, mid, H * W), (B, c, H, W), mid, c * 9),
              "w1_preact": ((B, mid, H * W), (B, mid, H * W), (B, c, H, W), mid, c * 9)}
    sa, sah, sb, M, N = shapes[kind]
    a, b = r(*sa), r(*sb)
    ah = r(*sah) if sah is not None else None
    beta_a, beta_b = (torch.tensor(v, dtype=torch.float64) for v in (0.7, 1.3))
    bin_ = "id" if kind == "w1" else "swish"
    shift = kind != "w2"
    splits, _ = ig.wgrad_splits(M, N, B, H * W)
    assert splits > 1
    part = torch.empty(splits, M, N, dtype=torch.float64)
    ig.rv_wgrad(a, ah, beta_a, b, None, beta_b, bin_, shift, "f32", part, H, W)
    out = torch.empty(M, N, dtype=torch.float64)
    ig.rv_wgrad_reduce(part, -1.0, out)
    A, Bm = ig._wgrad_operands(a, ah, beta_a, b, None, beta_b, bin_, shift, H, W)
    torch.testing.assert_close(out, -(A @ Bm.T), rtol=1e-12, atol=1e-12)
