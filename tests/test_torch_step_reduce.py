"""The two reductions that run on a thread-block cluster on the card, the
Broyden update ``broyden_step`` (``ops/fused_solve.py``, kernel
``csrc/broyden_step.cu``) and the final pair's scalar ``fp_tdot``
(``ops/fused_final.py``, kernel ``csrc/tdot.cu``), on the CPU through their
sum orders (``ops/sum_order.py``): ``*_exact`` sums in float64 and rounds
once, ``*_tiled`` sums as the cluster kernels do (each thread its vectors,
the warp's xor butterfly, the CTA's warps, the cluster's CTAs, each in
order), and stands in for the kernel here.

* ``broyden_step_exact`` / ``_tiled`` against ``_broyden_step_plain`` in all
  three phases at the flagship's D 3072 on states with nk 0, 1, 10 and 29
  planes written: the same ``ist`` (nstep, best step, flags) and next active
  list, every state tensor within 1e-6 (max error over the largest entry,
  at least 1); on half the slots under a permuted list the other examples
  untouched.
* The forward solve with ``broyden_step`` in either order against JAX's
  ``fused_broyden_solve`` in interpret mode, and the backward solve with the
  tiled order against JAX's ``fused_backward_solve``, at
  ``tests/test_torch_fused_solve.py``'s and
  ``tests/test_torch_tc_jt3x3.py``'s tolerances.
* ``fp_tdot_exact`` / ``_tiled`` against ``_fp_tdot_plain`` (1e-6 relative)
  and the final pair's T with either against JAX's ``fused_final_pair``
  (``tests/test_torch_final_pair.py``'s pattern and tolerances).
* ``_cluster_tree`` against a float32 simulation of the kernels' loops
  (threads, shuffles, warps, ranks), and on built inputs an order the
  sequential sum does not share.
* The host-side launch plans: ``broyden_plan`` at the three scales' D and
  K 4, 30 and 64 (its vectors cover D once) and at other widths, and
  ``tdot_plan`` at their M x HW (the chunks cover it once, 4 CTAs an SM
  where the batch allows), each raising on a size it cannot split.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import fused_final as ff
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import KW as BWD_KW
from test_torch_backward_solve import BF16_TOL, jax_chain_data, make_blocks, rel_norm, to_torch
from test_torch_final_pair import _inputs as _pair_inputs, _jax as _pair_jax
from test_torch_fused_solve import KW, _assert_match, _torch
from test_torch_tc_conv3x3_in import _wide_block
from test_torch_tc_final_out import _port_pair

STEP_FNS = {"exact": so.broyden_step_exact, "tiled": so.broyden_step_tiled}
TDOT_FNS = {"exact": so.fp_tdot_exact, "tiled": so.fp_tdot_tiled}
PHASES = {"init": fs.PHASE_INIT, "step": fs.PHASE_STEP, "rearm": fs.PHASE_REARM}
STEP_KW = dict(eps=1e-3, cap=30, patience=5, rtol=0.05, guard_eps=3e-3, newton=True)
D, K = 3072, 30  # the flagship's c H W at every scale, its threshold
SCALES = [(3, 32), (12, 16), (48, 8)]  # (c, H = W), mid 512


def _state(B, nk, seed):
    """A mid-solve state, as chip_smoke.py's broyden_state builds it."""
    rng = np.random.RandomState(seed)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    st = {k: rnd(B, D) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG")}
    st["G"] = st["GN"] + 0.5 * st["UPD"]  # a secant-like last step: <vT, dg> away from 0
    st["U"], st["V"] = torch.zeros(B, K, D), torch.zeros(B, K, D)
    st["U"][:, :nk], st["V"][:, :nk] = 0.01 * rnd(B, nk, D), 0.01 * rnd(B, nk, D)
    st["ist"] = torch.tensor([nk, nk, 0, 0], dtype=torch.int32).repeat(B, 1)
    norm = st["GN"].norm(dim=1)
    st["fst"] = torch.stack([norm * 1.5, norm * 2, norm * 3], 1).contiguous()
    return st


def _step(fn, phase, st0, idx):
    st = {k: v.clone() for k, v in st0.items()}
    io, co = torch.zeros(len(st0["Z"]), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    fn(phase, idx, torch.tensor([len(idx)], dtype=torch.int32), io, co, st, **STEP_KW)
    return st, io[:int(co)].sort().values


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0))


@pytest.mark.parametrize("fn", sorted(STEP_FNS))
@pytest.mark.parametrize("nk", [0, 1, 10, 29])
@pytest.mark.parametrize("phase", sorted(PHASES))
def test_broyden_step_orders_match_plain(phase, nk, fn):
    B = 4
    st0 = _state(B, nk, nk)
    idx = torch.arange(B, dtype=torch.int32)
    got, lst = _step(STEP_FNS[fn], PHASES[phase], st0, idx)
    ref, lref = _step(fs._broyden_step_plain, PHASES[phase], st0, idx)
    assert torch.equal(got["ist"], ref["ist"]) and torch.equal(lst, lref)
    err = max(_rel(got[k], ref[k]) for k in got)
    assert err <= 1e-6, err


@pytest.mark.parametrize("fn", sorted(STEP_FNS))
def test_broyden_step_partial_list(fn):
    B = 6
    st0 = _state(B, 10, 3)
    idx = torch.tensor([4, 1, 3], dtype=torch.int32)
    got, lst = _step(STEP_FNS[fn], fs.PHASE_STEP, st0, idx)
    ref, lref = _step(fs._broyden_step_plain, fs.PHASE_STEP, st0, idx)
    assert torch.equal(got["ist"], ref["ist"]) and torch.equal(lst, lref)
    assert max(_rel(got[k], ref[k]) for k in got) <= 1e-6
    for k in got:  # the dead slots' examples: bitwise as they were
        assert torch.equal(got[k][[0, 2, 5]], st0[k][[0, 2, 5]]), k
    assert not torch.equal(got["U"][[1, 3, 4]], st0["U"][[1, 3, 4]])  # plane 10 written


@pytest.mark.parametrize("fn,mode,ladder", [("tiled", "tf32", True), ("tiled", "tf32x", False),
                                            ("exact", "tf32", True), ("exact", "f32", False)])
def test_solve_with_broyden_step_order_matches_jax(fn, mode, ladder):
    x, _, dx, dz = _wide_block(True)
    kw = dict(KW, mode=mode, warm_start=True, newton_init=True)
    if ladder:  # phase 1 capped at 2 iterations: every example re-armed at tf32x, then f32
        kw.update(tail_mode=("tf32x", "f32"), tail_start=2)
    ref = jfs.fused_broyden_solve(jnp.asarray(x), dx, dz, interpret=True, secant_refs=True,
                                  reps=1, **kw)
    ops = dict(fs._PLAIN, broyden_step=STEP_FNS[fn])
    full = dict(stall_guard=None, tail_mode=None, tail_start=None, line_search=False)
    got = fs._solve(torch.from_numpy(x), _torch(dx), _torch(dz), ops, **dict(full, **kw))[0]
    _assert_match(ref, got)
    assert got.converged.all()


def test_backward_solve_with_tiled_broyden_step_matches_jax():
    jblock, v, _, x = make_blocks(3, 16, True)
    rng = np.random.RandomState(2)
    z = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    cd = jax_chain_data(jblock, v, z, "bf16")
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = np.asarray(jfs.fused_backward_solve(jnp.asarray(grad), cd, threshold=4,
                                                  mode="bf16", interpret=True, reps=1,
                                                  **BWD_KW))
    ops = dict(ig._PLAIN, broyden_step=so.broyden_step_tiled)
    got = ig._backward_solve(torch.from_numpy(grad), to_torch(cd), ops, threshold=4,
                             mode="bf16", **BWD_KW)
    control = ig.fused_backward_solve_plain(torch.from_numpy(grad), to_torch(cd), threshold=4,
                                            mode="f32", **BWD_KW)
    err = rel_norm(got.u.numpy(), ref, grad)
    assert err <= BF16_TOL < rel_norm(control.u.numpy(), ref, grad), err


def _tdot_inputs(Bt, M, HW, nets, seed):
    rng = np.random.RandomState(seed)
    r, h, th = (torch.from_numpy(rng.standard_normal((Bt, M, HW)).astype(np.float32))
                for _ in range(3))
    return r, h, th, torch.tensor([1.1, 0.9][:nets])


@pytest.mark.parametrize("fn", sorted(TDOT_FNS))
@pytest.mark.parametrize("nets", [1, 2])
def test_fp_tdot_orders_match_plain(fn, nets):
    r, h, th, beta = _tdot_inputs(8, 64, 64, nets, nets)
    got, ref = torch.empty(8), torch.empty(8)
    TDOT_FNS[fn](r, h, th, beta, got)
    ff._fp_tdot_plain(r, h, th, beta, ref)
    # T sums 4096 terms of size ~1: within 1e-6 of the largest |T| (>= 1)
    assert _rel(got, ref) <= 1e-6, _rel(got, ref)


@functools.lru_cache(maxsize=None)
def _pair_case(c, preact, mode):
    dx, dz, arrays, cot = _pair_inputs(c, preact)
    return (dx, dz, arrays, cot), _pair_jax(dx, dz, arrays, cot, mode)[0]


@pytest.mark.parametrize("fn", sorted(TDOT_FNS))
@pytest.mark.parametrize("c,preact,mode", [(3, True, "f32"), (12, False, "bf16")])
def test_final_pair_T_with_fp_tdot_order_matches_jax(c, preact, mode, fn):
    args, T_ref = _pair_case(c, preact, mode)
    T_got, _ = _port_pair(*args, mode, dict(ff._PLAIN, fp_tdot=TDOT_FNS[fn]))
    for t, r in zip(T_got, T_ref):
        if mode == "f32":  # tests/test_torch_final_pair.py's tolerances
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-5)
        else:
            assert rel_norm(t.numpy(), r) <= 2e-5, rel_norm(t.numpy(), r)


def _simulate_tree(p, cluster, threads, vpt):
    """A row's sum as the cluster kernels' loops take it, in numpy float32:
    thread by thread, the xor shuffles lane by lane, warps and ranks in
    order."""
    f32 = np.float32
    n = p.shape[0]
    nv = n // cluster // 4
    total = f32(0)
    for rank in range(cluster):
        chunk = p[rank * n // cluster:(rank + 1) * n // cluster].reshape(nv, 4)
        acc = np.zeros(threads, np.float32)
        for t in range(threads):
            for m in range(vpt):
                j = t + m * threads
                if j < nv:
                    for lane in range(4):
                        acc[t] = f32(acc[t] + chunk[j, lane])
        cta = f32(0)
        for w in range(threads // 32):
            v = acc[w * 32:(w + 1) * 32].copy()
            for o in (16, 8, 4, 2, 1):
                v = np.array([f32(v[i] + v[i ^ o]) for i in range(32)], np.float32)
            cta = f32(cta + v[0])
        total = f32(total + cta)
    return total


@pytest.mark.parametrize("n,cluster,threads,vpt", [(3072, 8, 96, 1), (784, 4, 64, 1),
                                                   (2048, 2, 64, 4)])
def test_cluster_tree_is_the_kernels_loop_order(n, cluster, threads, vpt):
    rng = np.random.RandomState(n)
    p = (rng.standard_normal((2, n)) * 10.0 ** rng.uniform(-3, 3, (2, n))).astype(np.float32)
    got = so._cluster_tree(torch.from_numpy(p), cluster, threads, vpt).numpy()
    for row in range(2):
        assert got[row] == _simulate_tree(p[row], cluster, threads, vpt)


def test_cluster_tree_is_not_the_sequential_sum():
    # 2^24 then four 1s: in order each 1 is lost (2^24 + 1 rounds to 2^24);
    # the tree gives thread 0 the 2^24 and thread 1 (the next vector) the
    # 1s, which the butterfly adds as one 4
    p = torch.zeros(1, 3072)
    p[0, 0], p[0, 4:8] = 2.0 ** 24, 1.0
    plan = fs.broyden_plan(3072, K)
    tree = so._cluster_tree(p, plan.cluster, plan.threads, plan.vpt)
    seq = torch.zeros(1)
    for v in p[0]:
        seq = seq + v
    assert float(tree) == float(p.double().sum()) == 2.0 ** 24 + 4
    assert float(seq) == 2.0 ** 24


@pytest.mark.parametrize("k", [4, 30, 64])
@pytest.mark.parametrize("c,h", SCALES)
def test_broyden_plan_covers_d(c, h, k):
    d = c * h * h
    plan = fs.broyden_plan(d, k)
    assert plan.cluster in fs.STEP_CLUSTERS and plan.cluster * plan.slice == d
    assert plan.threads % 32 == 0 and plan.threads <= fs.STEP_MAX_THREADS
    assert plan.vpt in fs.STEP_VPT
    covered = [rank * plan.slice + 4 * (t + m * plan.threads) + lane
               for rank in range(plan.cluster) for t in range(plan.threads)
               for m in range(plan.vpt) if t + m * plan.threads < plan.slice // 4
               for lane in range(4)]
    assert sorted(covered) == list(range(d))


@pytest.mark.parametrize("d,plan", [(784, (4, 196, 64, 1)), (192, (8, 24, 32, 1)),
                                    (12288, (8, 1536, 192, 2)), (32768, (8, 4096, 256, 4))])
def test_broyden_plan_other_widths(d, plan):
    # MNIST's 1x28x28 and a narrow block's 3x8x8 on clusters of 4 and 8;
    # 64x64 images past 256 threads of one vector each
    assert tuple(fs.broyden_plan(d, 30)) == plan


@pytest.mark.parametrize("d,k", [(8, 30), (3000, 30), (40000, 30), (3072, 65)])
def test_broyden_plan_refuses(d, k):
    with pytest.raises(ValueError):
        fs.broyden_plan(d, k)


@pytest.mark.parametrize("c,h", SCALES)
def test_tdot_plan_covers_m_hw(c, h):
    n = 512 * h * h
    for bt in (128, 2, 600):
        cluster, chunk = ff.tdot_plan(bt, n)
        assert cluster in ff.TDOT_CLUSTERS and cluster * chunk == n and chunk % 4 == 0
        assert bt * cluster >= 4 * ff.TDOT_SMS or cluster == ff.TDOT_CLUSTERS[-1]
        assert cluster == 1 or bt * cluster // 2 < 4 * ff.TDOT_SMS
    assert ff.tdot_plan(128, 12) == (1, 12)  # 12 splits into no 2 whole vector chunks


def test_tdot_plan_refuses():
    with pytest.raises(ValueError):
        ff.tdot_plan(128, 6)
