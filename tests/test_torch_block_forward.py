"""The merged implicit-block forward (``IMNF_FUSED_BLOCK=1``): the port's
``fused_block_forward`` (plain PyTorch versions, CPU) against the JAX
package's Pallas kernel in interpret mode, the merged training forward of
one block and the whole training step against the JAX package's
``IMNF_FUSED_BLOCK=interpret`` path, the protective-break patch and the gate.

The JAX package merges every block under ``interpret``; the port merges the
blocks with H*W >= ``IMNF_FUSED_SOLVE_MIN_HW``, set to 0 here so that both
sides merge every block. Weights are JAX-initialised and carried across;
probes and roulette draws are numpy arrays both sides take.

(a) ``fused_block_forward_plain`` vs JAX ``fused_block_forward(...,
    interpret=True)`` at (2, 3, 8, 8), idim 16, preact on and off. Mode f32:
    z and gx at rtol 1e-4 / atol 1e-5 (``tests/test_fused_solve.py``'s
    tolerances: float sums in another order), the best objective at atol
    1e-5, nstep, converged and protective-break flags equal, acc_x and acc_z
    at rtol 1e-4 / atol 1e-5. Mode tf32 with the ladder tf32x, f32 (phase 1
    capped at 2 iterations): z and gx as f32, nstep within one, flags
    equal, and the accs, whose chain runs in bfloat16, by rel_norm over acc
    - eps at 1e-4 (``test_torch_neumann_chain.py``'s bfloat16 tolerance);
    the control, the port's chain in mode f32 on the same inputs, must read
    above it.
(b) One block's training forward and backward, loss ``sum(z^2) +
    sum(dlogp)``: float32 modes, loss at rtol 1e-5 and every gradient
    (parameters and x) at rtol 5e-4 / atol 1e-5; the defaults (tf32 solve
    with its ladder, bf16 chain, bf16 estimator, backward solve and
    re-attachment), loss at 1e-3 relative and every gradient at cosine >=
    0.999.
(c) A row flagged protective gets the Banach fallback's z and gx, and its
    accs equal the probes; the other row is untouched.
(d) The gate: off by default; "1" merges the blocks with H*W >= min_hw
    only; grad_in_forward, neumann_grad=False and evaluation take the split
    path; a value other than "0" / "1" raises.
(e) The whole training step (``make_image_train_step``) on
    ``test_torch_train_step.py``'s small ImplicitFlow with every block
    merged on both sides, float32 modes, at that file's tolerances: loss
    rtol 1e-5, gradients rtol 5e-4 / atol 1e-5, and after 3 steps the
    parameters, buffers and EMA at atol 1e-5.
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
from implicit_normalizing_flows_tpu.training import ema_init as jema_init
from implicit_normalizing_flows_tpu.training import loops as jloops
from implicit_normalizing_flows_torch.config import kernel_config
from implicit_normalizing_flows_torch.layers import ImplicitBlock, implicit_block
from implicit_normalizing_flows_torch.models import build_conv_net
from implicit_normalizing_flows_torch.ops import fused_block as fb
from implicit_normalizing_flows_torch.ops import fused_solve as tfs
from implicit_normalizing_flows_torch.ops.broyden import fixed_point_iteration
from implicit_normalizing_flows_torch.ops.logdet import Draws
from implicit_normalizing_flows_torch.training import (jax_variables_to_torch,
                                                       make_image_train_step)

from test_torch_backward_solve import rel_norm
from test_torch_train_step import (B, F32_ENV, SIZE, _env, inject_jax_draws, jax_grads_by_path,
                                   jax_loss, jax_model, make_setup, optimizers, port_model,
                                   replay)

KW = dict(threshold=30, eps=1e-6, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
          newton_init=True, warm_start=True)
LADDER = dict(tail_mode=("tf32x", "f32"), tail_start=2)
CAP, N_POWER = 6, 4
BF16_TOL = 1e-4


def signed():
    ks = np.arange(1, CAP + 1)
    return (np.where(ks % 2 == 0, 1.0, -1.0) * np.linspace(1.0, 0.3, CAP)).astype(np.float32)


def make_blocks(preact, seed=1, c=3, hw=8, Bn=2):
    """A JAX block (idim 16, c x hw x hw, --mem-eff False, n_exact_terms 2),
    its variables, the port's block with the same weights, x (Bn, c, hw,
    hw) and two probes, numpy; ``preact`` False is a scale's first block."""
    def jnet():
        return jax_build_conv_net((c, hw, hw), 16, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3, 3,
                                  "swish", preact=preact, dropout=0.0, sn_atol=None,
                                  sn_rtol=None, learn_p=False, first_resblock=not preact)

    def tnet():
        return build_conv_net((c, hw, hw), 16, "3-1-3", 0.9, 3, preact, None, None,
                              first_resblock=not preact, device="cpu")

    jblock = JBlock(jnet(), jnet(), n_dist="poisson", n_exact_terms=2, grad_in_forward=False)
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((Bn, c, hw, hw)) * 0.5).astype(np.float32)
    v = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    block = ImplicitBlock(tnet(), tnet(), n_dist="poisson", n_exact_terms=2,
                          grad_in_forward=False, device="cpu")
    params, state = (jax.tree.map(np.asarray, v[k]) for k in ("params", "state"))
    block.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    probes = [rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32) for _ in range(2)]
    return jblock, v, block, x, probes


def jax_data(jblock, v, net):
    sub = {"params": v["params"][net], "state": v["state"][net]}
    return getattr(jblock, net).conv_forward_data(sub)


def torch_data(block, net):
    return {k: (a.detach() if torch.is_tensor(a) else a)
            for k, a in getattr(block, net).conv_forward_data().items()}


def port_block_forward(block, x, probes, mode, ladder, plain=True):
    fn = fb.fused_block_forward_plain if plain else fb.fused_block_forward
    return fn(torch.from_numpy(x), torch_data(block, "nnet_x"), torch_data(block, "nnet_z"),
              *(torch.from_numpy(p) for p in probes), torch.from_numpy(signed()), N_POWER,
              mode=mode, **KW, **ladder)


@pytest.mark.parametrize("preact", [True, False])
@pytest.mark.parametrize("mode", ["f32", "tf32"])
def test_block_forward_matches_jax(preact, mode):
    jblock, v, block, x, probes = make_blocks(preact)
    ladder = LADDER if mode == "tf32" else {}
    with jax.disable_jit(mode != "f32"):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref, rax, raz = jfs.fused_block_forward(
            jnp.asarray(x), jax_data(jblock, v, "nnet_x"), jax_data(jblock, v, "nnet_z"),
            *(jnp.asarray(p) for p in probes), jnp.asarray(signed()), N_POWER, mode=mode,
            interpret=True, **KW, **ladder)
    got, gax, gaz = port_block_forward(block, x, probes, mode, ladder)
    for g, r in ((got.result, ref.result), (got.gx, ref.gx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.diff.numpy(), np.asarray(ref.diff), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.prot_break.numpy(), np.asarray(ref.prot_break))
    dn = np.abs(got.nstep.numpy() - np.asarray(ref.nstep))
    assert (dn == 0).all() if mode == "f32" else (dn <= 1).all(), dn
    accs = list(zip((gax, gaz), (rax, raz), probes))
    for g, r, _ in accs:
        assert g.dtype == torch.float32 and g.shape == r.shape
    if mode == "f32":
        for g, r, _ in accs:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
        return
    err = max(rel_norm(g.numpy(), np.asarray(r), e) for g, r, e in accs)
    _, cax, caz = port_block_forward(block, x, probes, "f32", {})
    ctrl = min(rel_norm(c.numpy(), np.asarray(r), e)
               for c, (_, r, e) in zip((cax, caz), accs))
    assert err <= BF16_TOL < ctrl, (err, ctrl)


def block_loss_jax(jblock, v, x):
    def loss(params, xx):
        vv = {"params": params, "state": v["state"]}
        z, dlogp, _ = jblock.forward(vv, xx, jnp.zeros((x.shape[0],)),
                                     rng=jax.random.PRNGKey(2), train=True)
        return jnp.sum(z ** 2) + jnp.sum(dlogp)
    return loss


def block_loss_port(block, x, draws):
    xt = torch.from_numpy(x).requires_grad_(True)
    z, dlogp = block(xt, torch.zeros(x.shape[0]), draws, train=True)
    loss = torch.sum(z ** 2) + torch.sum(dlogp)
    names, ps = zip(*block.named_parameters())
    grads = torch.autograd.grad(loss, [xt, *ps], allow_unused=True)
    # geom_p and lamb are outside the loss's reach: zero, as JAX gives them
    return (loss.detach(), grads[0],
            {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, ps, grads[1:])})


@pytest.mark.parametrize("precision", ["f32", "defaults"])
def test_block_train_forward_matches_jax(monkeypatch, precision):
    jblock, v, block, x, probes = make_blocks(True, seed=4)
    draws = {"uniform": [None], "rademacher": probes, "roulette": [np.array([2])]}
    _env(monkeypatch, F32_ENV if precision == "f32" else {})
    if precision != "f32":
        for k in F32_ENV:
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("IMNF_FUSED_BLOCK", "interpret")
    inject_jax_draws(monkeypatch, draws)
    params = jax.tree.map(jnp.asarray, v["params"])
    with jax.disable_jit(precision != "f32"):
        loss_j, (gp_j, gx_j) = jax.value_and_grad(block_loss_jax(jblock, v, x),
                                                  argnums=(0, 1))(params, jnp.asarray(x))
    monkeypatch.setenv("IMNF_FUSED_BLOCK", "1")
    monkeypatch.setenv("IMNF_FUSED_SOLVE_MIN_HW", "0")
    merged = []
    monkeypatch.setattr(block, "_forward_merged",
                        lambda *a: merged.append(1) or ImplicitBlock._forward_merged(block, *a))
    loss_t, gx_t, gp_t = block_loss_port(block, x, Draws(replay=draws))
    assert merged == [1]
    ref = jax_grads_by_path(gp_j)
    ref["x"], gp_t["x"] = np.asarray(gx_j), gx_t
    assert ref.keys() == gp_t.keys()
    if precision == "f32":
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        for k, g in gp_t.items():
            np.testing.assert_allclose(g.numpy(), ref[k], rtol=5e-4, atol=1e-5, err_msg=k)
        return
    assert abs(float(loss_t) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    for k, g in gp_t.items():
        a, b = g.double().flatten(), torch.from_numpy(np.asarray(ref[k])).double().flatten()
        if float(b.norm()) == 0.0:
            assert float(a.norm()) == 0.0, k  # geom_p, lamb: no gradient
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.999, (k, cos)


def test_protective_break_patch(monkeypatch):
    """Example 0 flagged protective: its z and gx come from the Banach
    fallback from x, its accs are its probes; example 1 keeps the merged
    forward's values."""
    _, _, block, x, probes = make_blocks(True, seed=2)
    monkeypatch.setenv("IMNF_SOLVER_PRECISION", "float32")
    monkeypatch.setenv("IMNF_SOLVER_TAIL", "")
    xt = torch.from_numpy(x)
    ex, ez = (torch.from_numpy(p) for p in probes)
    dx, dz = torch_data(block, "nnet_x"), torch_data(block, "nnet_z")
    sc = torch.from_numpy(signed())
    z_hat0, z0, _, ax0, az0 = block.solve_merged(xt, dx, dz, ex, ez, sc, N_POWER)

    def flagged(*a, **k):
        res, ax, az = fb.fused_block_forward(*a, **k)
        return res._replace(prot_break=torch.tensor([True, False])), ax, az

    monkeypatch.setattr(implicit_block, "fused_block_forward", flagged)
    z_hat, z, diag, ax, az = block.solve_merged(xt, dx, dz, ex, ez, sc, N_POWER)
    assert float(diag[2]) == 1.0
    with torch.no_grad():
        x_embed = (block.nnet_x(xt) + xt).reshape(2, -1)
        bg = lambda zz: x_embed - block.nnet_z(zz.reshape(x.shape)).reshape(2, -1)
        fbz = fixed_point_iteration(bg, xt.reshape(2, -1), threshold=1000, eps=1e-6)
        fbg = bg(fbz) - fbz
    torch.testing.assert_close(z_hat[0].reshape(-1), fbz[0])
    torch.testing.assert_close(z[0].reshape(-1), fbz[0] + fbg[0])
    torch.testing.assert_close(ax[0], ex[0])
    torch.testing.assert_close(az[0], ez[0])
    for a, b in ((z_hat, z_hat0), (z, z0), (ax, ax0), (az, az0)):
        torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert not torch.equal(ax0[0], ex[0])


def test_gate(monkeypatch):
    """Which blocks take the merged path, and the raise."""
    _, _, block, x, probes = make_blocks(True, seed=3, hw=16)
    xt, draws = torch.from_numpy(x), Draws(replay={})
    ok = lambda b=block, train=True, hw=16: b._merged_forward_ok(
        xt[..., :hw, :hw], draws, train)
    assert kernel_config().fused_block == "0" and not ok()
    monkeypatch.setenv("IMNF_FUSED_BLOCK", "1")
    assert kernel_config().fused_solve_min_hw == 256
    assert ok(hw=16) and not ok(hw=8)  # 16x16 merges, 8x8 stays split
    monkeypatch.setenv("IMNF_FUSED_SOLVE_MIN_HW", "0")
    assert ok(hw=8)
    assert not ok(train=False) and not block._merged_forward_ok(xt, None, True)
    for attr, val in (("grad_in_forward", True), ("neumann_grad", False), ("n_probes", 2),
                      ("brute_force", True)):
        monkeypatch.setattr(block, attr, val)
        assert not ok(), attr
        monkeypatch.undo()
        monkeypatch.setenv("IMNF_FUSED_BLOCK", "1")
        monkeypatch.setenv("IMNF_FUSED_SOLVE_MIN_HW", "0")
    assert ok()
    # evaluation and the split training path never reach the merged forward
    monkeypatch.setattr(block, "_forward_merged", lambda *a: pytest.fail("merged"))
    block(xt, torch.zeros(2), Draws(replay={"roulette": [np.array([2])],
                                            "rademacher": probes}))
    for bad in ("interpret", "2", ""):
        monkeypatch.setenv("IMNF_FUSED_BLOCK", bad)
        with pytest.raises(ValueError, match="IMNF_FUSED_BLOCK"):
            kernel_config()
        with pytest.raises(ValueError, match="IMNF_FUSED_BLOCK"):
            block(xt, torch.zeros(2), draws, train=True)


def test_train_step_merged_matches_jax(monkeypatch):
    """The whole step with every block merged, float32 modes: the JAX side
    first (loss, gradients, 3 steps), then the port."""
    jmodel, params, state, x_u8, draws = make_setup()
    jmodel = jax_model(grad_in_forward=False)
    _env(monkeypatch, F32_ENV)
    monkeypatch.setenv("IMNF_FUSED_BLOCK", "interpret")
    inject_jax_draws(monkeypatch, draws)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss(jmodel)))(
        params, state, jnp.asarray(x_u8), key)
    opt_j, opt_t = optimizers()
    jstep = jloops.make_image_step(jmodel, opt_j, im_dim=3, imagesize=SIZE,
                                   n_lipschitz_iters=None)
    p, s, o, e = params, state, opt_j.init(params), jema_init(params)
    losses = []
    for _ in range(3):
        p, s, o, e, m = jstep(p, s, o, e, jnp.asarray(x_u8), jnp.zeros((B,), jnp.int32),
                              key, jnp.ones(()))
        losses.append((float(m["loss"]), float(m["broyden_converged"])))

    monkeypatch.setenv("IMNF_FUSED_BLOCK", "1")
    monkeypatch.setenv("IMNF_FUSED_SOLVE_MIN_HW", "0")
    model = port_model(params, state, grad_in_forward=False)
    merged, merge = [], ImplicitBlock._forward_merged
    monkeypatch.setattr(ImplicitBlock, "_forward_merged",
                        lambda self, *a: merged.append(1) or merge(self, *a))
    step = make_image_train_step(model, opt_t, imagesize=SIZE)
    loss_t, _, grads_t = step.grads(torch.from_numpy(x_u8), replay(draws))
    assert len(merged) == len(model.implicit_blocks())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    ref = jax_grads_by_path(grads_j)
    assert ref.keys() == grads_t.keys()
    for k, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=5e-4, atol=1e-5, err_msg=k)
    for loss, conv in losses:
        mt = step(torch.from_numpy(x_u8), replay(draws))
        np.testing.assert_allclose(float(mt["loss"]), loss, rtol=1e-5)
        assert float(mt["broyden_converged"]) == conv
    want = jax_variables_to_torch(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    ema = jax_grads_by_path(e)
    for k, t in step.ema.items():
        np.testing.assert_allclose(t.numpy(), ema[k], rtol=0, atol=1e-5, err_msg=k)

