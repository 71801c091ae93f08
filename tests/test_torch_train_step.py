"""The slice as a whole: the port's image training step (dequantise -> flow
-> bits/dim -> implicit gradient -> clip -> Adam -> power iteration -> EMA)
against the JAX package's ``make_image_step(model, optimizer, train=True)``
and ``jax.value_and_grad`` of its loss, on the same weights and the same
random draws.

Model: ImplicitFlow blocks 1-1, idim 16, 3x16x16, batch 4, actnorm,
preact, Poisson roulette, ``n_exact_terms`` 2, ``grad_in_forward`` True,
JAX-initialised (with the ActNorm data init) and carried across. The JAX
samplers (dequantisation noise, Rademacher probes, the Poisson draw) are
replaced by fixed numpy arrays that the port's ``Draws`` replays, so the
JAX step can be jitted. The JAX side runs its kernels in interpret mode.

(a) float32 modes: loss within rtol 1e-5; every parameter's gradient,
    matched by path, within rtol 5e-4 / atol 1e-5; after 3 full steps the
    parameters, the u/v/sigma buffers and the EMA shadow within atol 1e-5.
(b) defaults (bf16 backward solve, re-attachment and estimator): loss
    within 1e-3 relative and every gradient's cosine with JAX's >= 0.999.
(c) training with grad_in_forward=False raises NotImplementedError.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers import LogitTransform as JLogit
from implicit_normalizing_flows_tpu.layers.protocol import make_vars
from implicit_normalizing_flows_tpu.models import ImplicitFlow as JFlow
from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_tpu.training import adam as jadam
from implicit_normalizing_flows_tpu.training import ema_init as jema_init
from implicit_normalizing_flows_tpu.training import linear_warmup as jwarmup
from implicit_normalizing_flows_tpu.training import loops as jloops
from implicit_normalizing_flows_torch.data import synthetic_structured
from implicit_normalizing_flows_torch.layers import LogitTransform
from implicit_normalizing_flows_torch.models import ImplicitFlow
from implicit_normalizing_flows_torch.ops.logdet import Draws
from implicit_normalizing_flows_torch.training import (adam, jax_variables_to_torch,
                                                       linear_warmup,
                                                       make_image_train_step)

SMALL = dict(n_blocks=[1, 1], intermediate_dim=16, actnorm=True, coeff=0.9,
             vnorms="2222", n_dist="poisson", kernels="3-1-3", preact=True,
             sn_atol=1e-3, sn_rtol=1e-3, n_exact_terms=2)
B, SIZE = 4, 16
DIM = 3 * SIZE * SIZE
# each block's probe shape: scale 0 (3, 16, 16), scale 1 after the squeeze
PROBES = [(B, 3, SIZE, SIZE)] * 2 + [(B, 12, SIZE // 2, SIZE // 2)] * 2
F32_ENV = {"IMNF_SOLVER_PRECISION": "float32", "IMNF_SOLVER_TAIL": "",
           "IMNF_BF16_EST": "0", "IMNF_BWD_PRECISION": "f32",
           "IMNF_REATTACH_PRECISION": "f32"}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def make_setup():
    """(JAX model, params, state, x_u8, draws) with draws the numpy arrays
    both sides use: uniform noise, [eps_x, eps_z] per block, one Poisson
    draw per block."""
    jmodel = JFlow((B, 3, SIZE, SIZE), init_layer=JLogit(0.05), factor_out=False,
                   n_lipschitz_iters=None, n_power_series=None, fc_end=False,
                   activation_fn="swish", neumann_grad=True, grad_in_forward=True,
                   first_resblock=True, **SMALL)
    x_u8 = synthetic_structured(B, 3, SIZE, SIZE, seed=1)
    x0 = jnp.asarray((x_u8.astype(np.float32) + 0.5) / 256)
    v = jmodel.init(jax.random.PRNGKey(1), x0)
    v = jmodel.init_with_batch(v, x0, rng=jax.random.PRNGKey(2))
    params, state = (jax.tree.map(np.asarray, v[k]) for k in ("params", "state"))
    rng = np.random.RandomState(3)
    draws = {"uniform": [rng.uniform(size=x_u8.shape).astype(np.float32)],
             "rademacher": [rng.choice([-1.0, 1.0], size=s).astype(np.float32)
                            for s in PROBES],
             "roulette": [np.array([n]) for n in (2, 1)]}
    return jmodel, params, state, x_u8, draws


def inject_jax_draws(monkeypatch, draws):
    """Make the JAX samplers return ``draws`` (in call order, cycling, so a
    retrace sees the same numbers)."""
    calls = {"rademacher": 0, "roulette": 0}

    def dequantize(x_u8, rng, nvals=256, **kw):
        return (x_u8.astype(jnp.float32) + jnp.asarray(draws["uniform"][0])) / nvals

    def rademacher(key, shape, dtype=jnp.float32):
        i = calls["rademacher"] % len(draws["rademacher"])
        calls["rademacher"] += 1
        return jnp.asarray(draws["rademacher"][i], dtype).reshape(shape)

    def poisson(key, lam, shape=None, dtype=jnp.int32):
        i = calls["roulette"] % len(draws["roulette"])
        calls["roulette"] += 1
        return jnp.asarray(draws["roulette"][i], dtype).reshape(shape)

    monkeypatch.setattr(jloops, "dequantize", dequantize)
    monkeypatch.setattr(jld, "sample_rademacher", rademacher)
    monkeypatch.setattr(jax.random, "poisson", poisson)


def jax_loss(jmodel):
    """The density train loss of ``make_image_step`` (``loops.py:268-336``)."""
    def loss(params, state, x_u8, rng):
        k_noise, _, k_fwd = jax.random.split(rng, 3)
        x = jloops.dequantize(x_u8, k_noise)
        z, dlogp, _ = jmodel.forward(make_vars(params, state), x,
                                     jnp.zeros((x.shape[0],)), rng=k_fwd, train=True)
        logpx = jloops.standard_normal_logprob(z) - dlogp - math.log(256) * DIM
        return jnp.mean(-logpx / DIM / math.log(2))
    return loss


def port_model(params, state, grad_in_forward=True):
    model = ImplicitFlow((B, 3, SIZE, SIZE), init_layer=LogitTransform(0.05),
                         grad_in_forward=grad_in_forward, device="cpu", **SMALL)
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    return model


def optimizers():
    return (jadam(jwarmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0),
            adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0))


def replay(draws):
    return Draws(replay=draws)


def jax_grads_by_path(grads):
    return {k: v.numpy() for k, v in jax_variables_to_torch(
        jax.tree.map(np.asarray, grads), {}).items()}


def _env(monkeypatch, env):
    for k in ("IMNF_FUSED_SOLVE", "IMNF_FUSED_BWD", "IMNF_FUSED_REATTACH"):
        monkeypatch.setenv(k, "interpret")
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_train_step_f32_matches_jax(monkeypatch, setup):
    jmodel, params, state, x_u8, draws = setup
    _env(monkeypatch, F32_ENV)
    inject_jax_draws(monkeypatch, draws)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss(jmodel)))(
        params, state, jnp.asarray(x_u8), key)

    model = port_model(params, state)
    opt_j, opt_t = optimizers()
    step = make_image_train_step(model, opt_t, imagesize=SIZE)
    loss_t, _, grads_t = step.grads(torch.from_numpy(x_u8), replay(draws))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    ref = jax_grads_by_path(grads_j)
    assert ref.keys() == grads_t.keys()
    for k, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=5e-4, atol=1e-5, err_msg=k)

    # three full steps: Adam at warmup, power iteration, EMA
    jstep = jloops.make_image_step(jmodel, opt_j, im_dim=3, imagesize=SIZE,
                                   n_lipschitz_iters=None)
    p, s, o, e = params, state, opt_j.init(params), jema_init(params)
    for i in range(3):
        p, s, o, e, m = jstep(p, s, o, e, jnp.asarray(x_u8), jnp.zeros((B,), jnp.int32),
                              key, jnp.ones(()))
        mt = step(torch.from_numpy(x_u8), replay(draws))
        np.testing.assert_allclose(float(mt["loss"]), float(m["loss"]), rtol=1e-5)
        assert float(mt["broyden_converged"]) == float(m["broyden_converged"])
    want = jax_variables_to_torch(jax.tree.map(np.asarray, p),
                                  jax.tree.map(np.asarray, s))
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k, t in got.items():  # parameters and the u / v / sigma buffers
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    ema = jax_grads_by_path(e)
    for k, t in step.ema.items():
        np.testing.assert_allclose(t.numpy(), ema[k], rtol=0, atol=1e-5, err_msg=k)


def test_train_step_defaults_match_jax(monkeypatch, setup):
    """bf16 backward solve, re-attachment and Neumann estimator; tf32 forward
    solve with the tf32x / f32 ladder. The JAX side runs eagerly: XLA:CPU
    compiles no bf16 x bf16 -> f32 dot."""
    jmodel, params, state, x_u8, draws = setup
    _env(monkeypatch, {})
    for k in F32_ENV:
        monkeypatch.delenv(k, raising=False)
    inject_jax_draws(monkeypatch, draws)
    as_jnp = lambda t: jax.tree.map(jnp.asarray, t)
    with jax.disable_jit():
        loss_j, grads_j = jax.value_and_grad(jax_loss(jmodel))(
            as_jnp(params), as_jnp(state), jnp.asarray(x_u8), jax.random.PRNGKey(7))
    model = port_model(params, state)
    step = make_image_train_step(model, optimizers()[1], imagesize=SIZE)
    loss_t, _, grads_t = step.grads(torch.from_numpy(x_u8), replay(draws))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    ref = jax_grads_by_path(grads_j)
    for k, g in grads_t.items():
        a, b = g.double().flatten(), torch.from_numpy(ref[k]).double().flatten()
        if float(b.norm()) == 0.0:
            assert float(a.norm()) == 0.0, k  # geom_p, lamb: no gradient
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.999, (k, cos)


def test_training_without_grad_in_forward_raises(setup):
    _, params, state, x_u8, draws = setup
    model = port_model(params, state, grad_in_forward=False)
    step = make_image_train_step(model, optimizers()[1], imagesize=SIZE)
    with pytest.raises(NotImplementedError, match="next port slice"):
        step(torch.from_numpy(x_u8), replay(draws))
