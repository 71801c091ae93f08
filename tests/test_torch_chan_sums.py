"""The re-attachment's channel reduction ``rv_chan_sums``
(``ops/implicit_grad.py``, kernel ``csrc/chan_sums.cu``: a thread-block
cluster a channel) on the CPU through its sum orders (``ops/sum_order.py``):
``rv_chan_sums_exact`` sums each channel in float64 and rounds once,
``rv_chan_sums_tiled`` sums as the cluster kernel does and stands in for it
here.

* ``chan_sums_plan`` at the flagship's (M, B, HW) at all three scales and
  both widths (M = mid 512 and M = c), at narrow widths, MNIST's HW 49 and a
  batch below the cluster: the kernel's loop (each thread's vectors, the
  example and position carried from one vector to the next) covers every
  element of every channel once; a CTA an SM where M allows; no shape the
  one-block-a-channel kernel took is refused.
* ``rv_chan_sums_tiled`` and ``_exact`` against the plain version in the
  three forms the re-attachment launches (b3: no h, alpha -1; M = mid: h and
  dbeta; T0: h, dbeta, base and out): the sums within 2e-6 of the largest
  entry, ``out`` bitwise the plain version's (the same elementwise code).
* ``_cluster_tree`` with single-float vectors against a float32
  simulation of the kernel's loops, and on built inputs an order the
  sequential sum does not share.
* The whole re-attachment with ``rv_chan_sums`` in its kernel's order
  against JAX's ``fused_reattach_vjp`` in interpret mode, at
  ``tests/test_torch_reattach_vjp.py``'s tolerances (f32 rtol 5e-4 / atol
  1e-5; bf16 and tf32 rel_norm 2e-5, the bf16 control above it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops import fused_solve as jfs
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm
from test_torch_reattach_vjp import NAMES, ROUNDED_TOL, UNROUNDED, _inputs, _torch

B, MID = 64, 512
SCALES = [(3, 32), (12, 16), (48, 8)]  # (c, H = W)
FLAGSHIP = [(m, B, h * h) for c, h in SCALES for m in (MID, c)]
OTHER = [(64, 4, 64), (192, 2, 256), (48, 4, 49), (512, 4, 49), (3, 2, 1024), (3, 1, 4),
         (12, 5, 196), (7, 3, 10), (1, 1, 1)]


def _covered(M, Bn, HW, plan):
    """Offsets of each channel's elements as the kernel's loop reaches them
    (``csrc/chan_sums.cu``: thread i of CTA r starts at vector r nv + i of
    the channel's run list and steps CS_THREADS vectors by carrying its
    example b and position p), (M, n) with n = Bn HW."""
    T, vec = ig.CS_THREADS, plan.vec
    hv = max(HW // vec, 1)
    nv = plan.chunk // vec
    db, dp = T // hv, T % hv
    rows = []
    for m in range(M):
        offs = []
        for rank in range(plan.cluster):
            j0 = rank * nv + np.arange(T)
            b, p = j0 // hv, j0 % hv
            for j in range(0, nv, T):
                live = np.arange(T) + j < nv
                off = m * HW + b * (M * HW) + p * vec
                offs.append((off[live, None] + np.arange(vec)).ravel())
                p, b = p + dp, b + db
                b, p = b + (p >= hv), np.where(p >= hv, p - hv, p)
        rows.append(np.sort(np.concatenate(offs)) if offs else np.zeros(0, int))
    return rows


@pytest.mark.parametrize("M,Bn,HW", FLAGSHIP + OTHER)
def test_plan_covers_every_element_once(M, Bn, HW):
    plan = ig.chan_sums_plan(M, Bn, HW)
    n = Bn * HW
    assert plan.vec == (4 if HW % 4 == 0 else 1)
    assert plan.cluster in ig.CS_CLUSTERS and plan.cluster * plan.chunk == n
    assert plan.chunk % plan.vec == 0
    for m, offs in enumerate(_covered(M, Bn, HW, plan)):
        want = np.sort((np.arange(Bn)[:, None] * M * HW + m * HW + np.arange(HW)).ravel())
        np.testing.assert_array_equal(offs, want)


@pytest.mark.parametrize("M,Bn,HW", FLAGSHIP)
def test_plan_fills_the_card(M, Bn, HW):
    # the fewest CTAs a channel that give every SM one: 1 at mid 512, the
    # most (16) at c 3 and 12, 4 at c 48; whole examples a CTA at batch 64
    plan = ig.chan_sums_plan(M, Bn, HW)
    assert plan.cluster == {MID: 1, 3: 16, 12: 16, 48: 4}[M]
    assert plan.chunk % HW == 0
    for M2 in (1, 8, 9, 33, 66, 131, 132, 4096):
        c = ig.chan_sums_plan(M2, Bn, HW).cluster
        assert M2 * c >= ig.CS_SMS or c == ig.CS_CLUSTERS[-1]
        assert c == ig.CS_CLUSTERS[0] or M2 * (c // 2) < ig.CS_SMS


def test_plan_falls_back_to_single_floats():
    assert ig.chan_sums_plan(48, 4, 49) == (4, 1, 49)  # 196 elements: 8 CTAs would split 49
    assert ig.chan_sums_plan(512, 64, 1024, vec=1) == (1, 1, 65536)  # unaligned tensors
    assert ig.chan_sums_plan(3, 1, 4) == (1, 4, 4)  # one vector: one CTA
    t = torch.zeros(4 * 3 * 64 + 1)[1:].view(4, 3, 64)
    assert ig._chan_sums_vec(t, None) == 1 and ig._chan_sums_vec(torch.zeros(4, 3, 64)) == 4


def _form(form, Bn, M, HW, seed):
    rng = np.random.RandomState(seed)
    rnd = lambda: torch.from_numpy(rng.standard_normal((Bn, M, HW)).astype(np.float32))
    t = rnd()
    if form == "b3":
        return (t, None, 0.0, -1.0, None), False
    h = 2.0 * rnd()
    return (t, h, 0.9, 1.0, rnd() if form == "T0" else None), form == "T0"


def _run(fn, args, has_out):
    t, h = args[0], args[1]
    M = t.shape[1]
    sums = torch.full((M,), float("nan"))
    db = None if h is None else torch.full((M,), float("nan"))
    out = torch.full(t.shape, float("nan")) if has_out else None
    fn(*args, sums, db, out)
    return [v for v in (sums, db, out) if v is not None]


@pytest.mark.parametrize("form", ["b3", "mid", "T0"])
@pytest.mark.parametrize("Bn,M,HW", [(8, 64, 64), (8, 3, 256), (4, 48, 49), (2, 12, 64)])
def test_tiled_and_exact_against_plain(form, Bn, M, HW):
    args, has_out = _form(form, Bn, M, HW, seed=M + HW)
    plain = _run(ig._rv_chan_sums_plain, args, has_out)
    exact = _run(so.rv_chan_sums_exact, args, has_out)
    tiled = _run(so.rv_chan_sums_tiled, args, has_out)
    for i, (p, e, t) in enumerate(zip(plain, exact, tiled)):
        if has_out and i == len(plain) - 1:  # out: the same elementwise code
            assert torch.equal(t, p) and torch.equal(e, p)
            continue
        scale = float(e.abs().max())
        assert float((t - e).abs().max()) <= 2e-6 * scale
        assert float((p - e).abs().max()) <= 2e-6 * scale
    if form == "b3":  # alpha * sum t, rounded once
        assert torch.equal(exact[0], (-args[0].double().sum((0, 2))).float())


def _simulate(p, cluster, threads, vpt, vec):
    """A row's sum as the kernel's loops take it, in numpy float32: thread
    by thread over its vectors, each vector's lanes in order, the xor
    shuffles lane by lane, warps and ranks in order."""
    f32 = np.float32
    n = p.shape[0]
    nv = n // cluster // vec
    total = f32(0)
    for rank in range(cluster):
        chunk = p[rank * n // cluster:(rank + 1) * n // cluster].reshape(nv, vec)
        acc = np.zeros(threads, np.float32)
        for t in range(threads):
            for m in range(vpt):
                j = t + m * threads
                if j < nv:
                    for lane in range(vec):
                        acc[t] = f32(acc[t] + chunk[j, lane])
        cta = f32(0)
        for w in range(threads // 32):
            v = acc[w * 32:(w + 1) * 32].copy()
            for o in (16, 8, 4, 2, 1):
                v = np.array([f32(v[i] + v[i ^ o]) for i in range(32)], np.float32)
            cta = f32(cta + v[0])
        total = f32(total + cta)
    return total


@pytest.mark.parametrize("n,cluster,threads,vpt,vec", [(196, 4, 64, 1, 1), (784, 2, 64, 4, 1),
                                                       (1024, 8, 32, 1, 4)])
def test_cluster_tree_is_the_kernels_loop_order(n, cluster, threads, vpt, vec):
    rng = np.random.RandomState(n)
    p = (rng.standard_normal((2, n)) * 10.0 ** rng.uniform(-3, 3, (2, n))).astype(np.float32)
    got = so._cluster_tree(torch.from_numpy(p), cluster, threads, vpt, vec).numpy()
    for row in range(2):
        assert got[row] == _simulate(p[row], cluster, threads, vpt, vec)


def test_tiled_is_not_the_sequential_sum():
    # channel 0 of t (2, 3, 1024): 2^24 at the first element, then four 1s
    # at the next vector. In order each 1 is lost (2^24 + 1 rounds to
    # 2^24); the kernel gives the 1s to thread 1, whose 4 the butterfly adds
    # to thread 0's 2^24 at once
    t = torch.zeros(2, 3, 1024)
    t[0, 0, 0], t[0, 0, 4:8] = 2.0 ** 24, 1.0
    sums = torch.empty(3)
    so.rv_chan_sums_tiled(t, None, 0.0, 1.0, None, sums, None, None)
    seq = torch.zeros(())
    for v in t[:, 0].reshape(-1):
        seq = seq + v
    assert float(sums[0]) == float(t[:, 0].double().sum()) == 2.0 ** 24 + 4
    assert float(seq) == 2.0 ** 24


@pytest.mark.parametrize("c,hw,preact,mode", [
    (3, 8, True, "f32"), (3, 8, False, "f32"), (12, 8, True, "f32"),
    (3, 16, True, "bf16"), (12, 8, False, "bf16"), (3, 8, True, "tf32"),
])
def test_reattach_with_tiled_chan_sums_matches_jax(c, hw, preact, mode):
    x, z_hat, u, dx, dz, _ = _inputs(c, hw, preact)
    with jax.disable_jit(mode != "f32"):  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = jfs.fused_reattach_vjp(jnp.asarray(x), jnp.asarray(z_hat), jnp.asarray(u), dx,
                                     dz, mode=mode, interpret=True, reps=1)
    ops = dict(ig._PLAIN, rv_chan_sums=so.rv_chan_sums_tiled)
    args = (torch.from_numpy(x), torch.from_numpy(z_hat), torch.from_numpy(u), _torch(dx),
            _torch(dz))
    got = ig._reattach_vjp(*args, ops, mode)
    control = None if mode != "bf16" else ig._reattach_vjp(*args, ops, "f32")

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
        if control is not None and name not in UNROUNDED:
            ctrl = rel_norm(flat(control)[i][1].detach().numpy(), r, base)
            assert ctrl > ROUNDED_TOL, (name, ctrl)
