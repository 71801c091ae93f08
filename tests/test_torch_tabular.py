"""The tabular slice as a whole: the port's ``build_tabular_model`` with the
density evaluation and training steps against the JAX package's
``build_tabular_model`` / ``make_density_eval_step`` /
``make_density_train_step`` and ``jax.value_and_grad`` of its loss, on the
same weights and the same random draws.

Model: 3 implicit blocks of two ``D -> 32 -> 32 -> D`` sin MLPs, vnorms
``222``, coeff 0.99 (the POWER recipe cut to size), JAX-initialised and
carried across with ``jax_variables_to_torch``; the nets' zero-initialised
last layers are scaled back up by 1000 on both sides, so the solves and
log-dets have work to do. D 6 (POWER) and 43 (MINIBOONE's width): in
evaluation D 6 takes the brute-force log-det and D 43 the basic estimator.
The JAX samplers (Rademacher probes, the geometric roulette draw) are
replaced by fixed numpy arrays that the port's ``Draws`` replays.

(a) evaluation: loss within rtol 1e-5 at D 6, 1e-4 at D 43 (a 21-term
    series of float32 VJPs);
(b) float32 training (``IMNF_BWD_PRECISION=f32``): loss within rtol 1e-5,
    every gradient within rtol 5e-4 / atol 1e-5, and after 3 full steps
    (clip, Adam at warmup, adaptive power iteration, EMA) the parameters,
    the u / v / sigma buffers and the EMA within atol 1e-5; at D 6 also
    with the Armijo line search (``IMNF_LINE_SEARCH=1``);
(c) the bf16 backward solve (the default): loss within 1e-3 relative and
    every gradient's cosine with JAX's >= 0.999;
(d) the dense power iteration's u, v and sigma, of one layer and of a
    model's layers run together;
(e) the builder's default device, and the unported options raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.data import tabular as jtab
from implicit_normalizing_flows_tpu.layers import InducedNormDense as JDense
from implicit_normalizing_flows_tpu.layers.protocol import make_vars
from implicit_normalizing_flows_tpu.models import build_tabular_model as jbuild
from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_tpu.training import adam as jadam
from implicit_normalizing_flows_tpu.training import ema_init as jema_init
from implicit_normalizing_flows_tpu.training import linear_warmup as jwarmup
from implicit_normalizing_flows_tpu.training import loops as jloops
from implicit_normalizing_flows_torch.data import tabular
from implicit_normalizing_flows_torch.layers import InducedNormDense
from implicit_normalizing_flows_torch.layers.lipschitz import update_dense_lipschitz
from implicit_normalizing_flows_torch.models import build_tabular_model
from implicit_normalizing_flows_torch.ops.logdet import Draws
from implicit_normalizing_flows_torch.training import (adam, jax_variables_to_torch,
                                                       linear_warmup, make_density_eval_step,
                                                       make_density_train_step)

B, NBLOCKS = 16, 3
SMALL = dict(dims="32-32", nblocks=NBLOCKS, act="sin", coeff=0.99, vnorms="2222",
             atol=1e-3, rtol=1e-3)
DATA = {6: "power", 43: "miniboone"}


def make_setup(D):
    """(JAX model, params, state, x, draws): JAX-initialised weights with
    the last layers scaled up, a batch of the synthetic stand-in, and per
    block one roulette draw and the probes [eps_x, eps_z]."""
    jmodel = jbuild(D, eps_forward=1e-5, **SMALL)
    x = jtab.get_tabular_datasets(DATA[D], "/nonexistent", synthetic_fallback=True,
                                  synthetic_n=2000)[0][:B]
    v = jmodel.init(jax.random.PRNGKey(D), jnp.asarray(x))
    params, state = (jax.tree.map(np.asarray, v[k]) for k in ("params", "state"))
    for block in params:
        for net in ("nnet_x", "nnet_z"):
            last = block[net]["layers"][-1]
            last["weight"] = last["weight"] * np.float32(1000.0)
    rng = np.random.RandomState(D)
    draws = {"rademacher": [rng.choice([-1.0, 1.0], size=(B, D)).astype(np.float32)
                            for _ in range(2 * NBLOCKS)],
             "roulette": [np.array([n]) for n in (1, 3, 2)]}
    return jmodel, params, state, x, draws


@pytest.fixture(scope="module", params=[6, 43])
def setup(request):
    return make_setup(request.param)


@pytest.fixture(scope="module")
def setup6():
    return make_setup(6)


def inject_jax_draws(monkeypatch, draws):
    """Make the JAX samplers return ``draws`` in call order, cycling, so a
    retrace sees the same numbers."""
    calls = {"rademacher": 0, "roulette": 0}

    def take(kind, shape, dtype):
        i = calls[kind] % len(draws[kind])
        calls[kind] += 1
        return jnp.asarray(draws[kind][i], dtype).reshape(shape)

    monkeypatch.setattr(jld, "sample_rademacher",
                        lambda key, shape, dtype=jnp.float32: take("rademacher", shape, dtype))
    monkeypatch.setattr(jld, "sample_geometric",
                        lambda key, p, shape: take("roulette", shape, jnp.int32))


def port_model(params, state, D):
    model = build_tabular_model(D, eps_forward=1e-5, device="cpu", **SMALL)
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    return model


def replay(draws):
    return Draws(replay=draws)


def jax_loss(jmodel):
    """The density train loss of ``make_density_train_step`` at beta 1."""
    def loss(params, state, x, rng):
        z, dlogp, _ = jmodel.forward(make_vars(params, state), x, jnp.zeros((x.shape[0],)),
                                     rng=rng, train=True)
        return -jnp.mean(jloops.standard_normal_logprob(z) - dlogp)
    return loss


def by_path(tree):
    return {k: v.numpy() for k, v in jax_variables_to_torch(
        jax.tree.map(np.asarray, tree), {}).items()}


def optimizers():
    return (jadam(jwarmup(1e-3, 1000), grad_clip=1.0),
            adam(linear_warmup(1e-3, 1000), grad_clip=1.0))


def test_synthetic_data_matches_jax():
    for name in ("power", "miniboone"):
        want = jtab.get_tabular_datasets(name, "/nonexistent", synthetic_fallback=True,
                                         synthetic_n=3000)
        got = tabular.get_tabular_datasets(name, "/nonexistent", synthetic_fallback=True,
                                           synthetic_n=3000)
        for w, g in zip(want, got):
            assert g.dtype == np.float32 and np.array_equal(w, g)
    assert tabular.TABULAR_DIMS == jtab.TABULAR_DIMS
    rows = [b for b in tabular.batch_iterator(got[0], 64, np.random.RandomState(0))]
    want_rows = [b for b in jtab.batch_iterator(want[0], 64, np.random.RandomState(0))]
    assert len(rows) == len(want_rows) and all(np.array_equal(a, b)
                                               for a, b in zip(rows, want_rows))
    with pytest.raises(FileNotFoundError):
        tabular.get_tabular_datasets("power", "/nonexistent")


def test_eval_matches_jax(monkeypatch, setup):
    jmodel, params, state, x, draws = setup
    D = x.shape[1]
    inject_jax_draws(monkeypatch, draws)
    want, _, _ = jloops.make_density_eval_step(jmodel)(params, state, jnp.asarray(x),
                                                       jax.random.PRNGKey(3))
    step = make_density_eval_step(port_model(params, state, D))
    rec = replay(draws)
    got = step(torch.from_numpy(x), rec)
    np.testing.assert_allclose(float(got["loss"]), float(want),
                               rtol=1e-5 if D <= 10 else 1e-4)
    assert got["nll_vec"].shape == (B,) and got["z"].shape == (B, D)
    assert float(got["broyden_converged"]) == 1.0
    # the brute force draws nothing; the estimator one roulette draw and two
    # probes per block
    used = 0 if D <= 10 else 2 * NBLOCKS
    assert len(rec.replay["rademacher"]) == 2 * NBLOCKS - used


def test_train_step_f32_matches_jax(monkeypatch, setup):
    check_train_step_f32(monkeypatch, *setup)


def test_train_step_f32_line_search_matches_jax(monkeypatch, setup6):
    """(b) with ``IMNF_LINE_SEARCH=1``: the generic solver's Armijo search
    in every forward and backward solve (the backward's first step, +g,
    fails the test), both models built under it."""
    monkeypatch.setenv("IMNF_LINE_SEARCH", "1")
    _, params, state, x, draws = setup6
    check_train_step_f32(monkeypatch, jbuild(6, eps_forward=1e-5, **SMALL), params, state, x,
                         draws)


def check_train_step_f32(monkeypatch, jmodel, params, state, x, draws):
    D = x.shape[1]
    monkeypatch.setenv("IMNF_BWD_PRECISION", "f32")
    inject_jax_draws(monkeypatch, draws)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss(jmodel)))(
        params, state, jnp.asarray(x), key)

    model = port_model(params, state, D)
    opt_j, opt_t = optimizers()
    step = make_density_train_step(model, opt_t)
    loss_t, _, grads_t = step.grads(torch.from_numpy(x), replay(draws))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    ref = by_path(grads_j)
    assert ref.keys() == grads_t.keys()
    for k, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=5e-4, atol=1e-5, err_msg=k)

    jstep = jloops.make_density_train_step(jmodel, opt_j, n_lipschitz_iters=None)
    p, s, o, e = params, state, opt_j.init(params), jema_init(params)
    for _ in range(3):
        p, s, o, e, m = jstep(p, s, o, e, jnp.asarray(x), key, jnp.ones(()))
        mt = step(torch.from_numpy(x), replay(draws))
        np.testing.assert_allclose(float(mt["loss"]), float(m["loss"]), rtol=1e-5)
        for k in ("broyden_nstep", "broyden_converged", "broyden_prot_break"):
            np.testing.assert_allclose(float(mt[k]), float(m[k]), rtol=1e-6, err_msg=k)
    want = jax_variables_to_torch(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k, t in got.items():  # parameters and the u / v / sigma buffers
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    ema = by_path(e)
    for k, t in step.ema.items():
        np.testing.assert_allclose(t.numpy(), ema[k], rtol=0, atol=1e-5, err_msg=k)


def test_train_step_bf16_backward_matches_jax(monkeypatch, setup6):
    """The default backward solve: net z's VJPs on bfloat16-cast parameters,
    buffers and z."""
    jmodel, params, state, x, draws = setup6
    monkeypatch.delenv("IMNF_BWD_PRECISION", raising=False)
    inject_jax_draws(monkeypatch, draws)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss(jmodel)))(
        params, state, jnp.asarray(x), jax.random.PRNGKey(7))
    step = make_density_train_step(port_model(params, state, 6), optimizers()[1])
    loss_t, _, grads_t = step.grads(torch.from_numpy(x), replay(draws))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-3 * abs(float(loss_j))
    ref = by_path(grads_j)
    for k, g in grads_t.items():
        a, b = g.double().flatten(), torch.from_numpy(ref[k]).double().flatten()
        if float(b.norm()) == 0.0:
            assert float(a.norm()) == 0.0, k  # geom_p, lamb: no gradient
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.999, (k, cos)


# (in, out, how far the weight moves) per layer: one layer, or a model's
# layers of two shapes moved by different amounts, so that their adaptive
# stops fall at different iterations (JAX: 12, 9, 22 and 7)
POWER_LAYERS = {"one": [(32, 6, 0.1)],
                "model": [(32, 6, 0.1), (32, 6, 0.01), (32, 6, 0.3), (6, 32, 0.05)]}


@pytest.mark.parametrize("layers", list(POWER_LAYERS))
@pytest.mark.parametrize("n_iterations", [5, None])
def test_dense_power_iteration_matches_jax(n_iterations, layers):
    """u, v and sigma after the post-step power iteration (a fixed budget,
    and the adaptive atol / rtol 1e-3 stop of ``--sn-tol 1e-3``) on weights
    moved away from the one u and v settled on; a model's layers of one
    shape run together (``update_dense_lipschitz``), each as JAX runs it
    alone."""
    rng = np.random.RandomState(0)
    ports, wants = [], []
    for i, (din, dout, move) in enumerate(POWER_LAYERS[layers]):
        jl = JDense(din, dout, coeff=0.99, domain=2.0, codomain=2.0, atol=1e-3, rtol=1e-3)
        v = jl.init(jax.random.PRNGKey(i))
        w = np.asarray(v["params"]["weight"]) + move * rng.normal(size=(dout, din)).astype(
            np.float32)
        v = make_vars(dict(v["params"], weight=jnp.asarray(w)), v["state"])
        wants.append(jl.update_lipschitz(v, n_iterations)["state"])
        layer = InducedNormDense(din, dout, coeff=0.99, atol=1e-3, rtol=1e-3, device="cpu")
        layer.load_state_dict(jax_variables_to_torch(
            jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["state"])))
        ports.append(layer)
    if layers == "one":
        ports[0].update_lipschitz(n_iterations)
    else:
        update_dense_lipschitz(ports, n_iterations)
    for layer, want in zip(ports, wants):
        for k in ("u", "v", "sigma"):
            np.testing.assert_allclose(getattr(layer, k).numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_builder_defaults_to_the_card():
    """Without ``device`` the model is built on the card: here, with no
    CUDA device, that fails loudly instead of falling back to the CPU."""
    make = lambda **kw: build_tabular_model(6, dims="8", nblocks=1, **kw)
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in make().parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    model = make(device="cpu")
    assert all(t.device.type == "cpu" for t in [*model.parameters(), *model.buffers()])


def test_unported_options_raise(monkeypatch, setup6):
    _, params, state, x, draws = setup6
    for kw in (dict(vnorms="2f2"), dict(vnorms="121"), dict(actnorm=True),
               dict(batchnorm=True), dict(learn_p=True), dict(scan_blocks=True)):
        with pytest.raises(NotImplementedError):
            build_tabular_model(6, dims="8", nblocks=1, device="cpu", **kw)

    def step_raises(match, **block_attrs):
        model = port_model(params, state, 6)
        for b in model.implicit_blocks():
            for k, v in block_attrs.items():
                setattr(b, k, v)
        with pytest.raises(NotImplementedError, match=match):
            make_density_train_step(model, optimizers()[1])(torch.from_numpy(x),
                                                            replay(draws))

    step_raises("neumann_grad=True", neumann_grad=True)
    step_raises("grad_in_forward", grad_in_forward=True)
    step_raises("brute-force", brute_force=True)
