"""The port's inverse (sampling) path against the JAX package's, on the CPU.

Layer by layer (``unsqueeze``, ``ActNorm2d``, ``LogitTransform``,
``SequentialFlow``), the implicit block (the fused solve with the nets'
roles swapped: the JAX side runs its Pallas kernel with
``IMNF_FUSED_SOLVE=interpret``, the port its plain versions), a small
two-scale model, the CIFAR-10 flagship at full width on the committed
checkpoint, and the torch sampling driver. Tolerances are those of
``tests/test_torch_fused_solve.py``: rtol 1e-4 / atol 1e-5 on values (float
sums in another order); the flagship's pixels within 1e-3.
"""
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import qualitative_samples_torch as qst
from implicit_normalizing_flows_tpu.layers import ActNorm2d as JActNorm
from implicit_normalizing_flows_tpu.layers import LogitTransform as JLogit
from implicit_normalizing_flows_tpu.layers import SequentialFlow as JSeq
from implicit_normalizing_flows_tpu.layers import SqueezeLayer as JSqueeze
from implicit_normalizing_flows_tpu.layers.implicit_block import \
    ImplicitBlock as JBlock
from implicit_normalizing_flows_tpu.layers.implicit_block import \
    _fused_solve_data as jax_fused_solve_data
from implicit_normalizing_flows_tpu.layers.squeeze import unsqueeze as jax_unsqueeze
from implicit_normalizing_flows_tpu.models import ImplicitFlow as JFlow
from implicit_normalizing_flows_tpu.models.implicit_flow import \
    build_conv_net as jax_build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_tpu.ops import logdet as jld
from implicit_normalizing_flows_torch.layers import (ActNorm2d, ImplicitBlock, LogitTransform,
                                                     SequentialFlow, SqueezeLayer, implicit_block)
from implicit_normalizing_flows_torch.layers.squeeze import squeeze, unsqueeze
from implicit_normalizing_flows_torch.models import ImplicitFlow
from implicit_normalizing_flows_torch.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_torch.ops import fused_solve as tfs
from implicit_normalizing_flows_torch.ops.broyden import fixed_point_iteration
from implicit_normalizing_flows_torch.ops.logdet import Draws
from implicit_normalizing_flows_torch.training import jax_variables_to_torch, load_npz_tree

from test_torch_convert import CKPT, flagship_jax, flagship_torch
from test_torch_flow_eval import SMALL

VALUES = dict(rtol=1e-4, atol=1e-5)
MODE_ENV = {"f32": "float32", "tf32": "tensorfloat32", "tf32x": "tf32x"}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


# ---------------------------------------------------------------------------
# the layers

def _layers(case, rng):
    """(JAX layer, its variables, port layer, input y) of one case."""
    if case == "unsqueeze":
        return JSqueeze(2), {"params": {}, "state": {}}, SqueezeLayer(2), \
            rng.standard_normal((2, 12, 4, 4)).astype(np.float32)
    if case == "actnorm":
        w, b = (rng.standard_normal(3).astype(np.float32) * 0.3 for _ in range(2))
        port = ActNorm2d(3, device="cpu")
        port.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
        return JActNorm(3), {"params": {"weight": w, "bias": b}, "state": {}}, port, \
            rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    if case == "logit":
        return JLogit(0.05), {"params": {}, "state": {}}, LogitTransform(0.05), \
            (rng.standard_normal((2, 3, 8, 8)) * 2).astype(np.float32)
    # [ActNorm 3, squeeze, ActNorm 12], the scale's order
    ws = [(rng.standard_normal(c).astype(np.float32) * 0.3,
           rng.standard_normal(c).astype(np.float32) * 0.3) for c in (3, 12)]
    port = SequentialFlow([ActNorm2d(3, device="cpu"), SqueezeLayer(2),
                           ActNorm2d(12, device="cpu")])
    port.load_state_dict({f"{i}.{k}": torch.from_numpy(a) for i, (w, b) in zip((0, 2), ws)
                          for k, a in (("weight", w), ("bias", b))})
    params = [{"weight": ws[0][0], "bias": ws[0][1]}, {}, {"weight": ws[1][0], "bias": ws[1][1]}]
    return JSeq([JActNorm(3), JSqueeze(2), JActNorm(12)]), \
        {"params": params, "state": [{}, {}, {}]}, port, \
        rng.standard_normal((2, 12, 4, 4)).astype(np.float32)


@pytest.mark.parametrize("with_logp", [False, True])
@pytest.mark.parametrize("case", ["unsqueeze", "actnorm", "logit", "sequential"])
def test_inverse_layer_matches_jax(case, with_logp):
    """Each layer's inverse (and with logp, the log-det it adds) equals the
    JAX package's; unsqueeze exactly, and squeeze after it is the
    identity."""
    rng = np.random.RandomState(3)
    jlayer, v, layer, y = _layers(case, rng)
    logp = rng.standard_normal(2).astype(np.float32) if with_logp else None
    xj, lj = jlayer.inverse(v, jax.numpy.asarray(y),
                            None if logp is None else jax.numpy.asarray(logp))
    with torch.no_grad():
        x, lp = layer.inverse(torch.from_numpy(y), None if logp is None else torch.from_numpy(logp))
    assert (lp is None) == (not with_logp)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VALUES)
    if with_logp:
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **VALUES)
    if case == "unsqueeze":
        yt = torch.from_numpy(y)
        np.testing.assert_array_equal(unsqueeze(yt).numpy(), np.asarray(jax_unsqueeze(y)))
        assert torch.equal(squeeze(unsqueeze(yt)), yt)


# ---------------------------------------------------------------------------
# the implicit block

@pytest.fixture(scope="module")
def block_vars():
    """The small block of tests/test_torch_fused_solve.py (idim 16, 3x8x8,
    B 2), JAX-initialised: its variables as numpy, and a latent z."""
    block = _jax_block()
    rng = np.random.RandomState(0)
    z = (rng.standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(1), jax.numpy.asarray(z))
    return _np_tree(v), z


def _jax_block():
    def make_net():
        return jax_build_conv_net((3, 8, 8), 16, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3, 3,
                                  "swish", preact=True, dropout=0.0, sn_atol=None,
                                  sn_rtol=None, learn_p=False, first_resblock=False)

    return JBlock(make_net(), make_net(), n_dist="poisson")


def _port_block(v):
    make_net = lambda: build_conv_net((3, 8, 8), 16, "3-1-3", 0.9, 3, True, None, None,
                                      first_resblock=False, device="cpu")
    block = ImplicitBlock(make_net(), make_net(), n_dist="poisson", device="cpu")
    block.load_state_dict(jax_variables_to_torch(v["params"], v["state"]), strict=True)
    return block


def _solver_env(monkeypatch, mode, ladder, warm_start):
    monkeypatch.setenv("IMNF_FUSED_SOLVE", "interpret")
    monkeypatch.setenv("IMNF_SOLVER_PRECISION", MODE_ENV[mode])
    monkeypatch.setenv("IMNF_WARM_START", "1" if warm_start else "0")
    # phase 1 capped at 1 iteration, so that every example is re-armed at
    # tf32x (at eps 1e-5 these solves take 2-3 iterations)
    monkeypatch.setenv("IMNF_SOLVER_TAIL", "tf32x,f32" if ladder else "")
    monkeypatch.setenv("IMNF_LADDER_START", "1" if ladder else "0")


def _record_solves(monkeypatch):
    """Record the fused solves' results of both packages' blocks: (JAX's,
    the port's)."""
    seen = ([], [])
    jsolve, tsolve = jfs.fused_broyden_solve, implicit_block.fused_broyden_solve
    monkeypatch.setattr(jfs, "fused_broyden_solve",
                        lambda *a, **k: seen[0].append(jsolve(*a, **k)) or seen[0][-1])
    monkeypatch.setattr(implicit_block, "fused_broyden_solve",
                        lambda *a, **k: seen[1].append(tsolve(*a, **k)) or seen[1][-1])
    return seen


def _assert_solves_match(seen):
    """Per-example nstep within +-1, converged and protective-break flags
    equal (``tests/test_torch_fused_solve.py``)."""
    (ref,), (got,) = seen
    assert np.all(np.abs(got.nstep.numpy() - np.asarray(ref.nstep)) <= 1)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.prot_break.numpy(), np.asarray(ref.prot_break))


def _record_draws(monkeypatch):
    """Record the JAX block's roulette draws and probes, as the port's
    ``Draws`` replays them."""
    rec = {"roulette": [], "rademacher": []}
    sample_rad, sample_n = jld.sample_rademacher, jld.sample_n_dist

    def rec_rademacher(key, shape, dtype=jax.numpy.float32):
        out = sample_rad(key, shape, dtype)
        rec["rademacher"].append(np.asarray(out)[0])  # one probe
        return out

    def rec_sample_n(*a, **kw):
        out = sample_n(*a, **kw)
        rec["roulette"].append(np.asarray(out[2]))
        return out

    monkeypatch.setattr(jld, "sample_rademacher", rec_rademacher)
    monkeypatch.setattr(jld, "sample_n_dist", rec_sample_n)
    return rec


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("mode", ["f32", "tf32", "tf32x"])
def test_block_inverse_matches_jax(monkeypatch, block_vars, mode, ladder, warm_start):
    """``ImplicitBlock.inverse`` against the JAX block's, the solve at
    ``eps_sample`` with net z embedding and net x solved; every example
    converges."""
    v, z = block_vars
    _solver_env(monkeypatch, mode, ladder, warm_start)
    seen = _record_solves(monkeypatch)
    xj, _ = _jax_block().inverse(v, jax.numpy.asarray(z))
    block = _port_block(v)
    assert block.solver_cfg.eps_sample == 1e-5
    x, lp = block.inverse(torch.from_numpy(z))
    assert lp is None and not x.requires_grad
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VALUES)
    _assert_solves_match(seen)
    assert seen[1][0].converged.all()


def test_block_inverse_logpz_matches_jax(monkeypatch, block_vars):
    """With logpz: logpz plus the evaluation estimator's log-det at the
    solved x, on JAX's draws replayed."""
    v, z = block_vars
    _solver_env(monkeypatch, "tf32", True, True)
    rec = _record_draws(monkeypatch)
    logpz = np.array([0.25, -1.5], np.float32)
    xj, lj = _jax_block().inverse(v, jax.numpy.asarray(z), jax.numpy.asarray(logpz),
                                  rng=jax.random.PRNGKey(5))
    draws = Draws(replay=rec)
    x, lp = _port_block(v).inverse(torch.from_numpy(z), torch.from_numpy(logpz), draws)
    assert not any(draws.replay.values())  # every JAX draw was consumed
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VALUES)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **VALUES)


def _scaled(d):
    """An expansive copy of a ``conv_forward_data`` dict (w2, w3 x 20): its
    solve diverges and takes the protective break."""
    return dict(d, w2=d["w2"] * 20.0, w3=d["w3"] * 20.0)


def test_inverse_protective_break_matches_jax(monkeypatch, block_vars):
    """The solved net (net x) made expansive in the fused solve, as
    ``test_plain_solve_protective_break_matches_jax_kernel`` does: every row
    takes the Banach fallback from z on the block's own nets, against JAX's
    ``_fused_inverse``."""
    v, z = block_vars
    _solver_env(monkeypatch, "f32", False, True)
    seen = _record_solves(monkeypatch)
    jblock = _jax_block()
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    data_z, data_x, interp, reps = jax_fused_solve_data(
        jblock.nnet_z, jblock.nnet_x, sub("nnet_z"), sub("nnet_x"), jax.numpy.asarray(z))
    assert interp
    xj = jblock._fused_inverse(sub("nnet_x"), sub("nnet_z"), jax.numpy.asarray(z),
                               (data_z, _scaled(data_x), interp, reps))

    block = _port_block(v)
    data_x_t, data_z_t = block._forward_data()
    monkeypatch.setattr(block, "_forward_data", lambda: (_scaled(data_x_t), data_z_t))
    x, _ = block.inverse(torch.from_numpy(z))
    assert seen[1][0].prot_break.all()
    _assert_solves_match(seen)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VALUES)


def _banach_patch_before(block, x, res):
    """``ImplicitBlock._banach_patch`` as it was before the inverse shared
    it (the forward's roles and tolerance built in)."""
    cfg = block.solver_cfg
    B = x.shape[0]
    zf, gf = res.result.reshape(B, -1), res.gx.reshape(B, -1)
    if bool(res.prot_break.any()):
        x_embed = (block.nnet_x(x) + x).reshape(B, -1)
        bg = lambda zz: x_embed - block.nnet_z(zz.reshape(x.shape)).reshape(B, -1)
        fb = fixed_point_iteration(bg, x.reshape(B, -1), threshold=cfg.banach_threshold,
                                   eps=cfg.eps_forward)
        take = res.prot_break[:, None]
        zf = torch.where(take, fb, zf)
        gf = torch.where(take, bg(fb) - fb, gf)
    eps_i = cfg.eps_forward * (x[0].numel() ** 0.5)
    diag = implicit_block.solver_diag(res.nstep, res.converged, res.prot_break, res.diff, eps_i)
    return zf, gf, diag


@pytest.mark.parametrize("expansive", [False, True])
def test_forward_banach_patch_unchanged(monkeypatch, block_vars, expansive):
    """The forward's solve and its Banach patch give the same bits as
    before the patch took the roles and the tolerance as arguments, with
    and without protective-break rows."""
    v, x = block_vars
    _solver_env(monkeypatch, "tf32", True, True)
    block = _port_block(v)
    xt = torch.from_numpy(x)
    data_x, data_z = block._forward_data()
    data_z = _scaled(data_z) if expansive else data_z
    with torch.no_grad():
        res = tfs.fused_broyden_solve(xt, data_x, data_z, **block._fused_solve_kwargs())
        assert bool(res.prot_break.all()) == expansive
        got = block._banach_patch(xt, res, block.nnet_x, block.nnet_z,
                                  block.solver_cfg.eps_forward)
        want = _banach_patch_before(block, xt, res)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        z_hat, z, diag = block.solve(xt, data_x, data_z)
    assert torch.equal(z_hat, want[0].reshape(xt.shape))
    assert torch.equal(z, (want[0] + want[1]).reshape(xt.shape))
    assert torch.equal(diag, want[2])


def test_generic_block_inverse_raises():
    from implicit_normalizing_flows_torch.models import build_tabular_model

    model = build_tabular_model(6, dims="8-8", nblocks=1, device="cpu")
    with pytest.raises(NotImplementedError, match="module item 6"):
        model.inverse(torch.zeros(2, 6))


# ---------------------------------------------------------------------------
# the model

def test_small_flow_inverse_matches_jax(monkeypatch):
    """2 scales of one block each, idim 16, 3x8x8, B 2, JAX-initialised
    (with the ActNorm data init), at the default ladder: ``model.inverse``
    against JAX's, and the port's round trip ``forward(inverse(z)) = z``
    within 1e-3 (``tests/test_fused_solve.py``)."""
    B, size = 2, 8
    jmodel = JFlow((B, 3, size, size), init_layer=JLogit(0.05), factor_out=False,
                   n_lipschitz_iters=None, n_power_series=None, fc_end=False,
                   n_exact_terms=10, activation_fn="swish", neumann_grad=True,
                   grad_in_forward=False, first_resblock=True, **SMALL)
    rng = np.random.RandomState(2)
    x0 = jax.numpy.asarray(rng.uniform(0.1, 0.9, (B, 3, size, size)).astype(np.float32))
    v = jmodel.init(jax.random.PRNGKey(1), x0)
    v = _np_tree(jmodel.init_with_batch(v, x0, rng=jax.random.PRNGKey(2)))
    model = ImplicitFlow((B, 3, size, size), init_layer=LogitTransform(0.05), device="cpu",
                         **SMALL)
    model.load_state_dict(jax_variables_to_torch(v["params"], v["state"]), strict=True)
    assert model.dims == [tuple(d) for d in jmodel.dims] == [(12, 4, 4)]

    z = (0.8 * rng.standard_normal((B, 12 * 4 * 4))).astype(np.float32)
    monkeypatch.setenv("IMNF_FUSED_SOLVE", "interpret")
    xj, _ = jmodel.inverse(v, jax.numpy.asarray(z))
    with torch.no_grad():
        x, _ = model.inverse(torch.from_numpy(z))
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), **VALUES)
        zz, _ = model(x)
    np.testing.assert_allclose(zz.numpy(), z, atol=1e-3, rtol=0)


def test_flagship_inverse_matches_jax(monkeypatch):
    """The slice at full width: the committed CIFAR-10 checkpoint, one
    latent at tau 0.8, solver in float32 without the ladder. The JAX side
    runs its XLA solver path in float64 (``test_flagship_checkpoint_eval_
    matches_jax``), the port its plain path; pixels within 1e-3."""
    monkeypatch.setenv("IMNF_FUSED_SOLVE", "0")
    monkeypatch.setenv("IMNF_SOLVER_PRECISION", "float32")
    monkeypatch.setenv("IMNF_SOLVER_TAIL", "")
    ck = load_npz_tree(CKPT)
    f32 = lambda t: jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype == np.float16
        else np.asarray(a), t)
    params, state = f32(ck["params"]), f32(ck["state"])
    z = (0.8 * np.random.RandomState(0).standard_normal((1, 3072))).astype(np.float32)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(
            lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a, t)
        xj, _ = flagship_jax().inverse({"params": f64(params), "state": f64(state)},
                                       jax.numpy.asarray(z, jax.numpy.float64))
        xj = np.asarray(xj)
    model = flagship_torch()
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    with torch.no_grad():
        x, _ = model.inverse(torch.from_numpy(z))
    assert x.shape == (1, 3, 32, 32) and 0.0 < xj.min() and xj.max() < 1.0
    assert np.abs(x.numpy() - xj).max() <= 1e-3


# ---------------------------------------------------------------------------
# the sampling driver

def read_png(path):
    """(rows, cols, channels) uint8 of an 8-bit gray or RGB PNG with
    unfiltered rows, as ``qualitative_samples_torch.write_png`` writes."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    cols, rows, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and b"IEND" in chunks
    c = {0: 1, 2: 3}[ctype]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(rows, 1 + cols * c)
    assert (raw[:, 0] == 0).all()  # filter type None on every row
    return raw[:, 1:].reshape(rows, cols, c)


def test_sampling_driver_writes_the_inverse(tmp_path):
    """``main --device cpu --nsamples 2``: a valid PNG of two 32x32 tiles
    and a 2-pixel gutter, whose pixels equal ``ImplicitFlow.inverse`` of the
    same generator's draws, quantised as the grid quantises them."""
    out = tmp_path / "s.png"
    qst.main(["--device", "cpu", "--nsamples", "2", "--nrow", "2", "--seed", "3",
              "--out", str(out)])
    png = read_png(out)
    assert png.shape == (32, 66, 3)
    assert (png[:, 32:34] == 255).all()  # the gutter

    model = qst.load_flagship(CKPT, torch.device("cpu"))
    z = 0.8 * torch.randn(2, 3072, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        x, _ = model.inverse(z)
    want = (np.clip(x.numpy(), 0, 1).transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(png[:, :32], want[0])
    np.testing.assert_array_equal(png[:, 34:], want[1])


def test_sampling_driver_defaults_to_the_card(tmp_path):
    """Without ``--device`` the driver builds the model on the card: here,
    with no CUDA device, that fails loudly instead of falling back to the
    CPU."""
    assert qst.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        model = qst.load_flagship(CKPT, torch.device("cuda"))
        assert all(p.is_cuda for p in model.parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            qst.main(["--nsamples", "1", "--out", str(tmp_path / "s.png")])


@pytest.mark.parametrize("use_ema", [True, False])
def test_sampling_driver_takes_ema(monkeypatch, use_ema):
    """With ``--use-ema True`` and an ``ema`` tree the driver samples the
    EMA weights after a power iteration against them
    (``qualitative_samples.py:75-81``); else the checkpoint's weights as
    they are."""
    from implicit_normalizing_flows_torch import training

    ck = load_npz_tree(CKPT)
    ema = jax.tree.map(lambda a: np.asarray(a) * np.asarray(0.5, np.asarray(a).dtype), ck["params"])
    monkeypatch.setattr(training, "load_npz_tree", lambda path: dict(ck, ema=ema))
    powered = []
    monkeypatch.setattr(ImplicitFlow, "update_lipschitz", lambda self: powered.append(self))
    model = qst.load_flagship(CKPT, torch.device("cpu"), use_ema)
    bias = model.transforms[0][1].bias  # scale 0's first ActNorm
    want = ema if use_ema else ck["params"]
    np.testing.assert_array_equal(bias.detach().numpy(),
                                  np.asarray(want["transforms"][0][1]["bias"], np.float32))
    assert powered == ([model] if use_ema else [])
