"""The port's roulette coefficients and basic log-det estimator against the
JAX package's, fed the same draws (the JAX draws replayed into the port).
atol 1e-4 (float32 VJP chains summed in another order)."""
import jax
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_torch.ops import logdet as tld

from test_torch_nets import make_pair


@pytest.mark.parametrize("n_dist", ["poisson", "geometric"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_n_dist_matches_jax(n_dist, seed):
    cfg = jld.LogdetConfig(n_dist=n_dist, n_samples=3, n_exact_terms_test=20)
    geom_p, lamb = 0.5, 2.0
    coeffs, n_power, n_samples = jld.sample_n_dist(
        jax.random.PRNGKey(seed), cfg, jax.numpy.float32(geom_p),
        jax.numpy.float32(lamb), train=False)
    draws = tld.Draws(replay={"roulette": [np.asarray(n_samples)]})
    got, got_n, _ = tld.sample_n_dist(draws, n_dist, 3, geom_p, lamb, 20, 24, "cpu")
    assert got_n == int(n_power)
    np.testing.assert_allclose(got.numpy(), np.asarray(coeffs), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("preact", [True, False])
def test_basic_logdet_estimator_matches_jax(preact):
    jnet, v, tnet = make_pair(preact)
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    eps = (rng.randint(0, 2, x.shape) * 2 - 1).astype(np.float32)
    cfg = jld.LogdetConfig(n_dist="poisson", n_exact_terms_test=20)
    coeffs, n_power, _ = jld.sample_n_dist(jax.random.PRNGKey(5), cfg, 0.5, 2.0,
                                           train=False)
    ref = jld.basic_logdet_estimator(jnet.apply, v, jax.numpy.asarray(x),
                                     jax.numpy.asarray(eps), coeffs)
    got = tld.basic_logdet_estimator(tnet, torch.from_numpy(x),
                                     torch.from_numpy(eps),
                                     torch.from_numpy(np.array(coeffs)), int(n_power))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_draws_sample_shapes_and_values():
    d = tld.Draws(torch.Generator().manual_seed(0))
    r = d.rademacher((4, 5), "cpu")
    assert set(r.unique().tolist()) <= {-1.0, 1.0}
    u = d.uniform((3,), "cpu")
    assert bool(((u >= 0) & (u < 1)).all())
    assert d.roulette("geometric", 6, 0.5, 2.0, "cpu").min() >= 1
    assert d.roulette("poisson", 6, 0.5, 2.0, "cpu").shape == (6,)
