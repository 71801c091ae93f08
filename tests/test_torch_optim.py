"""The port's optimizer step (global-norm clip -> torch-semantics Adam ->
learning-rate schedule), warmup schedule and EMA against the JAX package's
``adam`` / ``linear_warmup`` / ``ema_apply`` on the same random tree of
parameters and gradients, float32 on both sides: rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from implicit_normalizing_flows_tpu.training import adam as jadam
from implicit_normalizing_flows_tpu.training import ema_apply as jema_apply
from implicit_normalizing_flows_tpu.training import linear_warmup as jwarmup
from implicit_normalizing_flows_torch.training import (adam, ema_apply, ema_init,
                                                       global_norm, linear_warmup)

SHAPES = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.beta": (1,), "c": ()}


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.standard_normal(s) * scale, np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_clip_ema_match_jax(weight_decay):
    """5 steps at a constant lr of 1e-3, betas (0.9, 0.99), clip 1.0; the
    gradients of steps 1 and 3 are large enough that the clip engages."""
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=(3.0 if i in (1, 3) else 0.05)) for i in range(5)]

    opt_j = jadam(jwarmup(1e-3, 0), betas=(0.9, 0.99), weight_decay=weight_decay,
                  grad_clip=1.0)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj, ej = opt_j.init(pj), dict(pj)

    opt = adam(linear_warmup(1e-3, 0), betas=(0.9, 0.99), weight_decay=weight_decay,
               grad_clip=1.0)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    st, et = opt.init(pt), ema_init(pt)

    clipped = []
    for g in grads:
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        upd, sj = opt_j.update(gj, sj, pj)
        pj = optax.apply_updates(pj, upd)
        ej = jema_apply(ej, pj, 0.999)
        gt = {k: torch.tensor(v) for k, v in g.items()}
        clipped.append(float(global_norm(gt)) > 1.0)
        st = opt.update(pt, gt, st)
        ema_apply(et, pt, 0.999)
        for k in SHAPES:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
            np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    assert clipped == [False, True, False, True, False]
    assert st.count == 5


def test_missing_gradient_counts_as_zero():
    opt = adam(linear_warmup(1e-3, 0), grad_clip=1.0)
    p = {"w": torch.ones(3)}
    st = opt.update(p, {"w": None}, opt.init(p))
    assert torch.equal(p["w"], torch.ones(3)) and st.count == 1


def test_linear_warmup_matches_jax():
    sj, st = jwarmup(1e-3, 1000), linear_warmup(1e-3, 1000)
    for count in (0, 1, 5, 998, 999, 1000, 5000):
        np.testing.assert_allclose(st(count), float(sj(jnp.asarray(count))), rtol=1e-6)
