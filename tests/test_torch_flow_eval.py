"""The slice as a whole: the port's image eval step (dequantise -> flow ->
per-example bits/dim) against the JAX package's ``make_image_step(...,
train=False)`` on the same weights and the same random draws.

The JAX eval runs eagerly (``jax.disable_jit``) with recording wrappers
around its samplers (dequantisation noise, Rademacher probes, roulette
draws); the recorded arrays are replayed into the port through
``ops.logdet.Draws``. Pass: per-example bpd within 1e-4 and z within 1e-4
relative.
"""
import jax
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers import LogitTransform as JLogit
from implicit_normalizing_flows_tpu.models import ImplicitFlow as JFlow
from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_tpu.training import loops as jloops
from implicit_normalizing_flows_torch.data import synthetic_structured
from implicit_normalizing_flows_torch.layers import LogitTransform
from implicit_normalizing_flows_torch.models import ImplicitFlow
from implicit_normalizing_flows_torch.ops.logdet import Draws
from implicit_normalizing_flows_torch.training import (jax_variables_to_torch,
                                                       load_npz_tree,
                                                       make_image_eval_step)

from test_torch_convert import CKPT, flagship_jax, flagship_torch

SMALL = dict(n_blocks=[1, 1], intermediate_dim=16, actnorm=True, coeff=0.9,
             vnorms="2222", n_dist="poisson", kernels="3-1-3", preact=True,
             sn_atol=1e-3, sn_rtol=1e-3)


def run_jax_eval(monkeypatch, model, params, state, x_u8, imagesize):
    """JAX eval metrics, the recorded draws and z."""
    rec = {"uniform": [], "rademacher": [], "roulette": [], "z": []}
    dequantize, sample_rad = jloops.dequantize, jld.sample_rademacher
    sample_n, logprob = jld.sample_n_dist, jloops.standard_normal_logprob

    def rec_dequantize(x, rng, **kw):
        rec["uniform"].append(np.asarray(jax.random.uniform(rng, x.shape)))
        return dequantize(x, rng, **kw)

    def rec_rademacher(key, shape, dtype=jax.numpy.float32):
        out = sample_rad(key, shape, dtype)
        rec["rademacher"].append(np.asarray(out)[0])  # one probe
        return out

    def rec_sample_n(*a, **kw):
        out = sample_n(*a, **kw)
        rec["roulette"].append(np.asarray(out[2]))
        return out

    def rec_logprob(z):
        rec["z"].append(np.asarray(z))
        return logprob(z)

    monkeypatch.setattr(jloops, "dequantize", rec_dequantize)
    monkeypatch.setattr(jld, "sample_rademacher", rec_rademacher)
    monkeypatch.setattr(jld, "sample_n_dist", rec_sample_n)
    monkeypatch.setattr(jloops, "standard_normal_logprob", rec_logprob)
    step = jloops.make_image_step(model, None, train=False, im_dim=3,
                                  imagesize=imagesize)
    with jax.disable_jit():
        m = step(params, state, jax.numpy.asarray(x_u8),
                 jax.numpy.zeros((x_u8.shape[0],), jax.numpy.int32),
                 jax.random.PRNGKey(7))
    return {k: np.asarray(v) for k, v in m.items()}, rec


def run_port_eval(model, x_u8, rec, imagesize):
    draws = Draws(replay={k: rec[k] for k in ("uniform", "rademacher", "roulette")})
    out = make_image_eval_step(model, imagesize=imagesize)(torch.from_numpy(x_u8), draws)
    assert not any(draws.replay.values())  # every JAX draw was consumed
    return out


def assert_eval_match(ref, rec, got):
    np.testing.assert_allclose(got["bpd_vec"].numpy(), ref["bpd_vec"], atol=1e-4, rtol=0)
    z_ref = rec["z"][0]
    err = np.abs(got["z"].numpy() - z_ref).max() / np.abs(z_ref).max()
    assert err < 1e-4, err
    for k in ("broyden_converged", "broyden_prot_break"):
        assert float(got[k]) == pytest.approx(float(ref[k])), k


def test_small_flow_eval_matches_jax(monkeypatch):
    """blocks 1-1, idim 16, 3x16x16, batch 4, JAX-initialised weights (with
    the ActNorm data init); the JAX solve runs its Pallas kernel in
    interpret mode, the port its plain versions, both at the default ladder
    (tf32, then tf32x and f32)."""
    monkeypatch.setenv("IMNF_FUSED_SOLVE", "interpret")
    B, size = 4, 16
    jmodel = JFlow((B, 3, size, size), init_layer=JLogit(0.05), factor_out=False,
                   n_lipschitz_iters=None, n_power_series=None, fc_end=False,
                   n_exact_terms=10, activation_fn="swish", neumann_grad=True,
                   grad_in_forward=False, first_resblock=True, **SMALL)
    x_u8 = synthetic_structured(B, 3, size, size, seed=1)
    x0 = jax.numpy.asarray((x_u8.astype(np.float32) + 0.5) / 256)
    v = jmodel.init(jax.random.PRNGKey(1), x0)
    v = jmodel.init_with_batch(v, x0, rng=jax.random.PRNGKey(2))
    params, state = (jax.tree.map(np.asarray, v[k]) for k in ("params", "state"))

    ref, rec = run_jax_eval(monkeypatch, jmodel, params, state, x_u8, size)
    model = ImplicitFlow((B, 3, size, size), init_layer=LogitTransform(0.05),
                         device="cpu", **SMALL)
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    got = run_port_eval(model, x_u8, rec, size)
    assert_eval_match(ref, rec, got)
    assert len(rec["roulette"]) == 2  # one per implicit block


def test_model_defaults_to_the_card():
    """Without ``device`` the model is built on the card: here, with no
    CUDA device, that fails loudly instead of falling back to the CPU."""
    make = lambda **kw: ImplicitFlow((2, 3, 8, 8), init_layer=LogitTransform(0.05),
                                     **SMALL, **kw)
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in make().parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    model = make(device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert all(b.device.type == "cpu" for b in model.buffers())


def test_flagship_checkpoint_eval_matches_jax(monkeypatch):
    """Full width: the committed CIFAR-10 checkpoint, batch 1, solver in
    float32 without the ladder. The JAX side runs its XLA solver path (which
    tests/test_fused_solve.py holds equal to the kernel at f32) in float64:
    its float32 CPU sums of the 524,288-term sigma dots are off by ~5e-4
    (see test_torch_convert.py), enough to move bpd by more than the
    tolerance."""
    monkeypatch.setenv("IMNF_FUSED_SOLVE", "0")
    monkeypatch.setenv("IMNF_SOLVER_PRECISION", "float32")
    monkeypatch.setenv("IMNF_SOLVER_TAIL", "")
    ck = load_npz_tree(CKPT)
    f32 = lambda t: jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype == np.float16
        else np.asarray(a), t)
    params, state = f32(ck["params"]), f32(ck["state"])
    x_u8 = synthetic_structured(1, 3, 32, 32, seed=1)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(
            lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a, t)
        ref, rec = run_jax_eval(monkeypatch, flagship_jax(), f64(params), f64(state),
                                x_u8, 32)
    model = flagship_torch()
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    got = run_port_eval(model, x_u8, rec, 32)
    assert_eval_match(ref, rec, got)
    assert float(got["broyden_converged"]) == 1.0


def test_synthetic_structured_matches_jax():
    from implicit_normalizing_flows_tpu.data.images import _synthetic_structured

    for n, seed in [(3, 1), (64, 1), (2, 7)]:
        np.testing.assert_array_equal(
            synthetic_structured(n, 3, 32, 32, seed=seed),
            _synthetic_structured("t", n, 3, 32, 32, seed=seed).x)


def test_config_mirrors_jax(monkeypatch):
    """Same defaults and IMNF_* names as the JAX KernelConfig's fields."""
    from dataclasses import fields

    from implicit_normalizing_flows_tpu import config as jcfg
    from implicit_normalizing_flows_torch import config as tcfg

    jdef, tdef = jcfg.KernelConfig(), tcfg.KernelConfig()
    for f in fields(tcfg.KernelConfig):
        assert getattr(tdef, f.name) == getattr(jdef, f.name), f.name
        assert tcfg._ENV_BY_FIELD[f.name] == jcfg._ENV_BY_FIELD[f.name]
    monkeypatch.setenv("IMNF_SOLVER_TAIL", "f32")
    monkeypatch.setenv("IMNF_STALL_PATIENCE", "0")
    monkeypatch.setenv("IMNF_FWD_THRESHOLD", "12")
    kc = tcfg.kernel_config()
    assert (kc.solver_tail, kc.stall_patience, kc.fwd_threshold) == ("f32", 0, 12)
