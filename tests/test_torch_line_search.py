"""The port's Armijo line search (``IMNF_LINE_SEARCH=1``) against the JAX
package's, on the CPU with the plain versions.

(a) the generic ``broyden(line_search=True)`` against JAX's
    ``ops/broyden.py`` on the residuals of JAX's
    ``test_armijo_line_search_same_root_and_tames_overshoot`` and
    ``test_line_search_noop_on_easy_problem`` (numpy inputs from a seed);
(b) the plain fused forward solve against ``fused_broyden_solve`` in
    interpret mode (``newton_init`` False) and against JAX's XLA path (its
    generic solver with the search on the block's residual, which JAX's
    ``test_fused_line_search_matches_xla`` holds to the kernel), with and
    without the ladder, ``newton_init`` False and True;
(c) the backward solve against ``fused_backward_solve`` in interpret mode;
(d) a block's forward and inverse against JAX's block;
(e) the search's three plain steps, with NaN and inf residuals, against a
    numpy statement of the semantics, and its exact and tiled sums;
(f) the search off: no search step runs and the solves are bitwise those
    of the code without it;
(g) the ``newton_init=False`` cases of (b) and (c) take shortened steps.

The overshooting nets of (b) are the block's net z with w2 and w3 scaled
(7x, 8.25x): the full Broyden steps overshoot and the quadratic trials are
taken. Tolerances are those of ``tests/test_torch_fused_solve.py``:
rtol 1e-4 / atol 1e-5, nstep within 1, flags equal.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers.implicit_block import ImplicitBlock as JBlock
from implicit_normalizing_flows_tpu.models.implicit_flow import \
    build_conv_net as jax_build_conv_net
from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_tpu.ops.broyden import broyden as jbroyden
from implicit_normalizing_flows_torch.layers import ImplicitBlock, implicit_block
from implicit_normalizing_flows_torch.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_torch.ops import broyden as tbr
from implicit_normalizing_flows_torch.ops import fused_solve as tfs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import line_search as lsm
from implicit_normalizing_flows_torch.ops import sum_order as so
from implicit_normalizing_flows_torch.training import jax_variables_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_backward_solve import jax_chain_data, make_blocks, to_torch  # noqa: E402

VALUES = dict(rtol=1e-4, atol=1e-5)
KW = dict(threshold=30, eps=1e-6, stall_patience=5, stall_rtol=0.05, stall_guard=3.0)


def _shortened():
    t = lsm.read_tally()
    return t["quadratic"] + t["halved"]


# ---------------------------------------------------------------------------
# (a) the generic solver

def _check_generic(got, want, exact_steps=True):
    for name in ("result", "gx"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   **VALUES, err_msg=name)
    if exact_steps:
        assert int(got.nstep) == int(want.nstep)
    for name in ("converged", "prot_break"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_generic_broyden_tames_overshoot_as_jax():
    """A steep residual whose full steps overshoot (Jacobian up to 5I): the
    search's rows reach the root where the plain solver's do not, on both
    sides alike."""
    B, D = 3, 6
    c = np.random.RandomState(5).standard_normal((B, D)).astype(np.float32)
    kw = dict(threshold=60, eps=1e-6)
    want = jbroyden(lambda x: 5.0 * jnp.tanh(x - jnp.asarray(c)), jnp.zeros((B, D)),
                    line_search=True, **kw)
    g = lambda x: 5.0 * torch.tanh(x - torch.from_numpy(c))
    got = tbr.broyden(g, torch.zeros(B, D), line_search=True, **kw)
    plain = tbr.broyden(g, torch.zeros(B, D), **kw)
    _check_generic(got, want)
    assert int(got.converged.sum()) > int(plain.converged.sum())
    conv = got.converged.numpy()
    np.testing.assert_allclose(got.result.numpy()[conv], c[conv], atol=1e-4)


def test_generic_broyden_noop_on_easy_problem():
    """A contraction: every full step passes the test, so the search
    changes nothing (bitwise) and matches JAX's."""
    B, D = 2, 8
    b = np.random.RandomState(6).standard_normal((B, D)).astype(np.float32)
    kw = dict(threshold=30, eps=1e-7)
    want = jbroyden(lambda z: jnp.asarray(b) - 0.3 * jnp.tanh(z) - z, jnp.zeros((B, D)),
                    line_search=True, **kw)
    g = lambda z: torch.from_numpy(b) - 0.3 * torch.tanh(z) - z
    got = tbr.broyden(g, torch.zeros(B, D), line_search=True, **kw)
    plain = tbr.broyden(g, torch.zeros(B, D), **kw)
    _check_generic(got, want)
    assert torch.equal(got.result, plain.result) and int(got.nstep) == int(plain.nstep)


# ---------------------------------------------------------------------------
# (b) the fused forward solve

def _make_jnet():
    return jax_build_conv_net((3, 8, 8), 16, "3-1-3", 0.9, [2.0] * 3, [2.0] * 3, 3, "swish",
                              preact=True, dropout=0.0, sn_atol=None, sn_rtol=None,
                              learn_p=False, first_resblock=False)


@pytest.fixture(scope="module")
def nets():
    """The small block of tests/test_torch_fused_solve.py (idim 16, 3x8x8,
    B 2), JAX-initialised: x, both nets' conv_forward_data as numpy, and
    the variables."""
    block = JBlock(_make_jnet(), _make_jnet(), n_dist="poisson")
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    v = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    sub = lambda n: {"params": v["params"][n], "state": v["state"][n]}
    to_np = lambda d: {k: (np.asarray(a) if k != "preact" else a) for k, a in d.items()}
    return (x, to_np(block.nnet_x.conv_forward_data(sub("nnet_x"))),
            to_np(block.nnet_z.conv_forward_data(sub("nnet_z"))), jax.tree.map(np.asarray, v))


def _torch(d):
    return {k: (torch.from_numpy(np.array(a)) if k != "preact" else a) for k, a in d.items()}


def _overshoot(d, scale):
    return dict(d, w2=d["w2"] * np.float32(scale), w3=d["w3"] * np.float32(scale))


def _assert_match(ref, got):
    np.testing.assert_allclose(got.result.numpy(), np.asarray(ref.result), **VALUES)
    np.testing.assert_allclose(got.gx.numpy(), np.asarray(ref.gx), **VALUES)
    assert np.all(np.abs(got.nstep.numpy() - np.asarray(ref.nstep)) <= 1)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.prot_break.numpy(), np.asarray(ref.prot_break))


def test_fused_solve_matches_jax_kernel(nets):
    """Overshooting nets (net z's w2, w3 x 8.25), mode f32, ``newton_init``
    False: the Pallas kernel in interpret mode and the plain solve take the
    same shortened steps."""
    x, dx, dz, _ = nets
    dz = _overshoot(dz, 8.25)
    kw = dict(KW, mode="f32", newton_init=False, line_search=True)
    ref = jfs.fused_broyden_solve(jnp.asarray(x), dx, dz, interpret=True, reps=1, **kw)
    lsm.reset_tally()
    got = tfs.fused_broyden_solve_plain(torch.from_numpy(x), _torch(dx), _torch(dz), **kw)
    _assert_match(ref, got)
    assert _shortened() > 0  # (g)


def _jax_net(d):
    """``conv_forward_data`` dict ``d``'s net in JAX: [swish] conv3x3 + b1,
    swish, conv1x1 + b2, swish, conv3x3 + b3 (``fused_solve._make_eval``),
    on float32 products."""
    conv = lambda v, w, pad: jax.lax.conv_general_dilated(
        v, jnp.asarray(w), (1, 1), [(pad, pad)] * 2, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    bias = lambda b: jnp.asarray(b)[None, :, None, None]
    sw = lambda t, b: t * jax.nn.sigmoid(t * b) * np.float32(1 / 1.1)
    beta = [float(b) for b in np.asarray(d["betas"])]

    def net(v):
        h = sw(v, beta[0]) if d["preact"] else v
        h = sw(conv(h, d["w1"], 1) + bias(d["b1"]), beta[1])
        h = sw(conv(h, d["w2"], 0) + bias(d["b2"]), beta[2])
        return conv(h, d["w3"], 1) + bias(d["b3"])
    return net


# (newton_init, mode, ladder start or None, net z's scale): the ladder's
# overshooting case takes shortened steps in its tf32 phase
XLA_CASES = [(True, "f32", None, 1.0), (False, "tf32", None, 1.0), (False, "tf32", 15, 7.0)]


@pytest.mark.parametrize("newton,mode,start,scale", XLA_CASES)
def test_fused_solve_matches_jax_xla_path(nets, newton, mode, start, scale):
    """JAX's generic solver with the search (its XLA path, float32
    products) on the block's residual ``x + g_x(x) - g_z(z) - z`` and the
    port's plain fused solve with it: roots and converged flags."""
    x, dx, dz, _ = nets
    dz = _overshoot(dz, scale)
    B = x.shape[0]
    xj = jnp.asarray(x)
    x_embed = (xj + _jax_net(dx)(xj)).reshape(B, -1)
    net_z = _jax_net(dz)
    g = lambda zf: x_embed - net_z(zf.reshape(x.shape)).reshape(B, -1) - zf
    want = jbroyden(g, jnp.zeros_like(x_embed), newton_init=newton, line_search=True, **KW)
    kw = dict(KW, mode=mode, newton_init=newton, line_search=True)
    if start is not None:
        kw.update(tail_mode=("tf32x", "f32"), tail_start=start)
    lsm.reset_tally()
    got = tfs.fused_broyden_solve_plain(torch.from_numpy(x), _torch(dx), _torch(dz), **kw)
    np.testing.assert_allclose(got.result.reshape(B, -1).numpy(), np.asarray(want.result),
                               **VALUES)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    if start is not None:
        assert _shortened() > 0  # (g)


# ---------------------------------------------------------------------------
# (c) the backward solve

@pytest.mark.parametrize("newton", [False, True])
def test_backward_solve_matches_jax_kernel(newton):
    """``u (I + J_gz) = grad`` with the search, threshold 8 (eps 1e-10: the
    whole budget), mode f32, against the Pallas kernel in interpret mode.
    The backward's residual grows along +g, so ``newton_init`` True fails
    the test at its first step; False takes a shortened step near the
    float32 floor."""
    jblock, v, _, x = make_blocks(3, 8, True)
    rng = np.random.RandomState(2)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "f32")
    kw = dict(threshold=8, eps=1e-10, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
              newton_init=newton, line_search=True, mode="f32")
    ref = jfs.fused_backward_solve(jnp.asarray(grad), cd, interpret=True, reps=1, **kw)
    lsm.reset_tally()
    got = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd), **kw)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref), **VALUES)
    tally = lsm.read_tally()
    assert tally["failed"] > 0
    if not newton:
        assert _shortened() > 0  # (g)


# ---------------------------------------------------------------------------
# (d) a block's forward and inverse

def _port_block(v):
    make_net = lambda: build_conv_net((3, 8, 8), 16, "3-1-3", 0.9, 3, True, None, None,
                                      first_resblock=False, device="cpu")
    block = ImplicitBlock(make_net(), make_net(), n_dist="poisson", device="cpu")
    block.load_state_dict(jax_variables_to_torch(v["params"], v["state"]), strict=True)
    return block


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_block_matches_jax(monkeypatch, nets, direction):
    """``IMNF_LINE_SEARCH=1``, ``IMNF_NEWTON_INIT=0`` (the first step fails
    the test), float32 products: the block's forward (eval) and inverse
    against JAX's block with its Pallas solve in interpret mode; both solves
    run the search."""
    x, _, _, v = nets
    for k, val in (("IMNF_FUSED_SOLVE", "interpret"), ("IMNF_LINE_SEARCH", "1"),
                   ("IMNF_NEWTON_INIT", "0"), ("IMNF_SOLVER_PRECISION", "float32"),
                   ("IMNF_SOLVER_TAIL", "")):
        monkeypatch.setenv(k, val)
    seen = ([], [])
    jsolve, tsolve = jfs.fused_broyden_solve, implicit_block.fused_broyden_solve
    monkeypatch.setattr(jfs, "fused_broyden_solve",
                        lambda *a, **k: seen[0].append((k, jsolve(*a, **k))) or seen[0][-1][1])
    monkeypatch.setattr(implicit_block, "fused_broyden_solve",
                        lambda *a, **k: seen[1].append((k, tsolve(*a, **k))) or seen[1][-1][1])
    jblock, block = JBlock(_make_jnet(), _make_jnet(), n_dist="poisson"), _port_block(v)
    lsm.reset_tally()
    if direction == "forward":
        want, _, _ = jblock.forward(v, jnp.asarray(x))
        got, _ = block(torch.from_numpy(x))
    else:
        want, _ = jblock.inverse(v, jnp.asarray(x))
        got, _ = block.inverse(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUES)
    ((jkw, ref),), ((tkw, res),) = seen
    assert jkw["line_search"] and tkw["line_search"]
    assert np.all(np.abs(res.nstep.numpy() - np.asarray(ref.nstep)) <= 1)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    assert lsm.read_tally()["failed"] > 0


# ---------------------------------------------------------------------------
# (e) the three steps on built states

def _state(rng, B=8, D=32):
    """A solver state whose rows probe every branch: row 0 passes the test;
    1 takes the quadratic trial; 2 the halved; 3 keeps the full step; 4's
    phi1 is NaN (no failure); 5's is inf (sq 1e-2); 6's quadratic residual
    is NaN (the halved is tried); 7 is off the list."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    st = {k: torch.from_numpy(f(B, D)) for k in ("Z", "G", "UPD")}
    st["ZN"] = st["Z"] + st["UPD"]
    G = st["G"]
    scale = torch.tensor([0.5, 1.5, 2.0, 1.2, 1.0, 1.0, 3.0, 2.0])[:, None]
    st["GN"] = G * scale
    st["GN"][4, 3] = float("nan")
    st["GN"][5, 7] = float("inf")
    ls = lsm.line_search_buffers(B, D, torch.device("cpu"))
    ls["GQ"].copy_(G * torch.tensor([1, 0.5, 1.1, 1.1, 1, 1.5, 1, 1])[:, None])
    ls["GQ"][6, 0] = float("nan")
    ls["GH"].copy_(G * torch.tensor([1, 1, 0.9, 1.2, 1, 0.8, 0.5, 1])[:, None])
    return st, ls


def _reference(st0, ls0, idx):
    """The semantics (``fused_solve.py:610-642``) in numpy float64 with each
    comparison's float32 operands: {row: (z_new, g_new, sq or None)}."""
    c1 = 1e-4
    out = {}
    n64 = lambda t: t.double().numpy()
    for e in idx:
        g, gn = n64(st0["G"][e]), n64(st0["GN"][e])
        z, upd = n64(st0["Z"][e]), n64(st0["UPD"][e])
        phi0, phi1 = float(np.sum(g * g)), float(np.sum(gn * gn))
        if not phi1 > phi0 * (1 - c1):
            out[e] = (n64(st0["ZN"][e]), gn, None)
            continue
        sq = min(max(phi0 / (2 * phi1 + 1e-30), 1e-2), 1.0) if np.isfinite(phi1) else 1e-2
        gq, gh = n64(ls0["GQ"][e]), n64(ls0["GH"][e])
        if float(np.sum(gq * gq)) <= phi0 * (1 - c1 * sq):
            out[e] = (z + sq * upd, gq, sq)
        elif float(np.sum(gh * gh)) <= phi0 * (1 - c1 * sq / 2):
            out[e] = (z + sq / 2 * upd, gh, sq)
        else:
            out[e] = (n64(st0["ZN"][e]), gn, sq)
    return out


@pytest.mark.parametrize("fn", ["plain", "exact", "tiled"])
def test_search_steps_on_built_states(fn):
    """The three steps on a permuted list of 7 of 8 rows, the trial
    residuals given: lists, tally and picks as the semantics say, the row
    off the list untouched."""
    search = {"plain": lsm._line_search_plain, "exact": so.line_search_exact,
              "tiled": so.line_search_tiled}[fn]
    st0, ls0 = _state(np.random.RandomState(3))
    st = {k: v.clone() for k, v in st0.items()}
    ls = lsm.line_search_buffers(8, 32, torch.device("cpu"))
    ls["GQ"].copy_(ls0["GQ"])
    ls["GH"].copy_(ls0["GH"])
    idx = torch.tensor([6, 2, 0, 5, 3, 1, 4, 7], dtype=torch.int32)
    cnt = torch.tensor([7], dtype=torch.int32)
    lsm.reset_tally()
    search(lsm.PHASE_TEST, st, ls, idx, cnt)
    assert sorted(ls["fail"][:int(ls["nfail"])].tolist()) == [1, 2, 3, 5, 6]
    search(lsm.PHASE_HALF, st, ls)
    assert sorted(ls["half"][:int(ls["nhalf"])].tolist()) == [2, 3, 5, 6]
    search(lsm.PHASE_PICK, st, ls)
    assert lsm.read_tally() == {"failed": 5, "quadratic": 1, "halved": 3, "full": 1}
    want = _reference(st0, ls0, idx[:7].tolist())
    assert float(ls["lsf"][5, 1]) == pytest.approx(0.5e-2)  # inf phi1: sq 1e-2, halved
    for e, (z, g, sq) in want.items():
        np.testing.assert_allclose(st["ZN"][e].double().numpy(), z, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(st["GN"][e].numpy(), g.astype(np.float32))
        if sq is not None:  # the quadratic trial's step, or the halved one's
            step = sq if e == 1 else sq / 2
            assert float(ls["lsf"][e, 1]) == pytest.approx(step, rel=1e-6)
    for k in st:
        assert torch.equal(st[k][7], st0[k][7]), k


# ---------------------------------------------------------------------------
# (f) the search off

def test_search_off_runs_no_search_step(nets):
    """With ``line_search`` False the solves never reach a search step and
    broyden_step takes UPD: the forward and backward solves are bitwise
    those whose broyden_step is called as before the search existed."""
    x, dx, dz, _ = nets

    def refuse(*a, **k):
        raise AssertionError("a search step ran with the search off")

    def step_as_before(phase, idx_in, cnt_in, idx_out, cnt_out, st, *, line_search=False, **k):
        assert not line_search
        return tfs._broyden_step_plain(phase, idx_in, cnt_in, idx_out, cnt_out, st, **k)

    kw = dict(KW, mode="tf32", newton_init=False, warm_start=False, tail_mode=("tf32x", "f32"),
              tail_start=2, line_search=False)
    args = (torch.from_numpy(x), _torch(dx), _torch(dz))
    want = tfs.fused_broyden_solve_plain(*args, **kw)
    ops = dict(tfs.solve_ops(plain=True), line_search=refuse, broyden_step=step_as_before)
    got = tfs._solve(*args, ops, **kw)[0]
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    jblock, v, _, xb = make_blocks(3, 8, True)
    cd = to_torch(jax_chain_data(jblock, v, xb, "f32"))
    grad = torch.from_numpy(np.random.RandomState(4).standard_normal(xb.shape)
                            .astype(np.float32))
    bkw = dict(threshold=4, eps=1e-10, stall_patience=5, stall_rtol=0.05, newton_init=True,
               mode="f32")
    want = ig.fused_backward_solve_plain(grad, cd, **bkw)
    got = ig._backward_solve(grad, cd, dict(ig._PLAIN, line_search=refuse,
                                            broyden_step=step_as_before), **bkw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_generic_search_off_runs_no_search(monkeypatch):
    """The generic solver with ``line_search`` False never reaches the
    search."""
    monkeypatch.setattr(tbr, "_armijo", lambda *a: (_ for _ in ()).throw(AssertionError))
    b = torch.from_numpy(np.random.RandomState(6).standard_normal((2, 8)).astype(np.float32))
    res = tbr.broyden(lambda z: b - 0.3 * torch.tanh(z) - z, torch.zeros(2, 8), 30, 1e-7)
    assert bool(res.converged.all())
