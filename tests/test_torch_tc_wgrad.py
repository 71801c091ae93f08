"""The Python side of the backward's two tensor-core stages of mode bf16 on
the CPU: the backward solve's 1x1 product ``jt_conv1x1_mid`` and the
split-K weight gradient ``rv_wgrad`` (kernels in ``csrc/mma_gemm.cuh`` and
``csrc/wgrad_tc.cuh``, held against these plain versions on the card by
``chip_smoke.py``), at the kernels' smallest tiles: mid 128 (one 128-row
tile), 8x8 images (one 64-pixel step an example), c 3.

* ``_rv_wgrad_plain`` in bf16, its splits summed by ``_rv_wgrad_reduce_plain``,
  against the JAX package's ``_dot_nt`` under ``_make_dot("bf16")``
  (``implicit_normalizing_flows_tpu/ops/fused_solve.py``) on operands made
  with the JAX kernels' own swish family and im2col shift, for every weight
  gradient the re-attachment and the final pair launch;
* the exact sums of ``ops/sum_order.py`` (the sum-order floors of
  ``chip_smoke.py`` phases 6 and 9) against a float64 numpy product, to one
  float32 ulp;
* ``_jt_conv1x1_mid_plain`` on a partial active list (count < B, a
  permuted idx) against the JAX stage ``d2(t) * s1`` (``_make_wdot``) on
  the live slots, the dead slots untouched;
* the W2^T that the backward solve prepares once per solve for the tensor
  cores: bfloat16, exact, in the layout and strides the kernel reads.

Tolerances are the suite's for unrounded bf16 products, rel_norm 2e-5
(``test_torch_tc_gemm.py``, ``test_torch_reattach_vjp.py``), each beside the
control, the plain version in mode f32 on the same inputs, which must read
above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.fused_solve import (_dot_nt, _dswish, _make_dot,
                                                            _make_wdot, _swish)
from implicit_normalizing_flows_torch.ops import implicit_grad as ig
from implicit_normalizing_flows_torch.ops import sum_order as so

from test_torch_backward_solve import rel_norm

MID, C, H, W, BN = 128, 3, 8, 8, 4
HW = H * W
TOL = 2e-5
BETAS = (0.8, 1.1, 1.3)


def _jax(fn, *arrays):
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        return np.asarray(fn(*(jnp.asarray(a) for a in arrays)))


def _im2col(v):
    """(Bn, Cb, H, W) -> (Bn, Cb * 9, HW), row ci*9 + ky*3 + kx holding
    v[ci][y + ky - 1][x + kx - 1] (zero padding)."""
    p = np.pad(v, ((0, 0), (0, 0), (1, 1), (1, 1)))
    taps = [p[:, :, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)]
    return np.stack(taps, 2).reshape(v.shape[0], -1, HW)


# kind: (rows of a, ah?, beta_a, rows of b, bin, bh?, beta_b, shift)
KINDS = {
    "reattach dW3": (C, False, None, MID, "swish", False, 2, True),
    "reattach dW2": (MID, True, 2, MID, "swish", False, 1, False),
    "reattach dW1": (MID, True, 1, C, "swish", False, 0, True),
    "reattach dW1 no preact": (MID, True, 1, C, "id", False, None, True),
    "final pair dW3": (C, False, None, MID, "dswish", True, 2, True),
    "final pair dW2": (MID, False, None, MID, "dswish", True, 1, False),
    "final pair dW1": (MID, False, None, C, "dswish", True, 0, True),
}


def _wgrad_case(kind, seed):
    ma, has_ah, ia, nb_, bin_, has_bh, ib, shift = KINDS[kind]
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    a, b = r(BN, ma, HW), r(BN, nb_, H, W)
    ah = r(BN, ma, HW) if has_ah else None
    bh = r(BN, nb_, H, W) if has_bh else None
    return a, ah, ia, b, bh, ib, bin_, shift


@pytest.mark.parametrize("kind", list(KINDS))
def test_rv_wgrad_plain_matches_jax(kind):
    a, ah, ia, b, bh, ib, bin_, shift = _wgrad_case(kind, len(kind))
    t = lambda v: None if v is None else torch.from_numpy(v)
    beta = lambda i: None if i is None else torch.tensor(BETAS[i])

    # the JAX operands: its kernels' swish family, then the im2col shift
    A = a if ah is None else _jax(lambda x, h: x * _dswish(h, jnp.float32(BETAS[ia])), a, ah)
    Bv = b
    if bin_ == "swish":
        Bv = _jax(lambda x: _swish(x, jnp.float32(BETAS[ib])), b)
    elif bin_ == "dswish":
        Bv = _jax(lambda x, h: x * _dswish(h, jnp.float32(BETAS[ib])), b, bh)
    Bm = _im2col(Bv) if shift else Bv.reshape(BN, b.shape[1], HW)
    flat = lambda v: np.ascontiguousarray(v.transpose(1, 0, 2).reshape(v.shape[1], -1))
    ref = _jax(lambda x, y: _dot_nt(_make_dot("bf16"), x, y), flat(A.reshape(BN, -1, HW)),
               flat(Bm))

    M, N = A.shape[1], Bm.shape[1]
    S, kchunk = ig.wgrad_splits(M, N, BN, HW)
    assert kchunk % HW == 0 and S * kchunk >= BN * HW  # whole examples

    def run(mode):
        part, out = torch.zeros(S, M, N), torch.zeros(M, N)
        ig._rv_wgrad_plain(t(a), t(ah), beta(ia), t(b), t(bh), beta(ib), bin_, shift, mode,
                           part, H, W)
        ig._rv_wgrad_reduce_plain(part, 1.0, out)
        return out.numpy()

    err, ctrl = rel_norm(run("bf16"), ref), rel_norm(run("f32"), ref)
    assert err <= TOL < ctrl, (err, ctrl)


def _ulps(got, want):
    """|got - want| in float32 ulps of want."""
    want32 = want.astype(np.float32)
    return float(np.max(np.abs(got.astype(np.float64) - want32) / np.spacing(np.abs(want32))))


@pytest.mark.parametrize("kind", ["reattach dW3", "reattach dW2", "final pair dW1"])
def test_rv_wgrad_exact_is_the_float64_product(kind):
    a, ah, ia, b, bh, ib, bin_, shift = _wgrad_case(kind, 100 + len(kind))
    t = lambda v: None if v is None else torch.from_numpy(v)
    beta = lambda i: None if i is None else torch.tensor(BETAS[i])
    args = (t(a), t(ah), beta(ia), t(b), t(bh), beta(ib), bin_, shift)
    A, Bm = ig._wgrad_operands(*args, H, W)
    M, N = A.shape[0], Bm.shape[0]
    S, kchunk = ig.wgrad_splits(M, N, BN, HW)
    part = torch.zeros(S, M, N)
    so.rv_wgrad_exact(*args, "bf16", part, H, W)
    bf = lambda v: v.to(torch.bfloat16).double().numpy()
    for s in range(S):
        k = slice(s * kchunk, (s + 1) * kchunk)
        want = bf(A[:, k]) @ bf(Bm[:, k]).T
        assert _ulps(part[s].numpy(), want) <= 1.0, s


def test_jt_conv1x1_mid_exact_is_the_float64_product():
    rng = np.random.RandomState(3)
    w2t = torch.from_numpy(rng.standard_normal((MID, MID, 1, 1)).astype(np.float32) / MID ** 0.5)
    t = torch.from_numpy(rng.standard_normal((BN, MID, HW)).astype(np.float32))
    s1 = torch.ones(BN, MID, HW)
    idx = torch.arange(BN, dtype=torch.int32)
    out = torch.zeros(BN, MID, HW)
    so.jt_conv1x1_mid_exact(t, idx, torch.tensor([BN], dtype=torch.int32),
                            ig.prep_mid_weight(w2t, "bf16"), s1, "bf16", out, H, W)
    bf = lambda v: v.to(torch.bfloat16).double().numpy()
    want = np.einsum("mk,bkp->bmp", bf(w2t[:, :, 0, 0]), bf(t))
    assert _ulps(out.numpy(), want) <= 1.0


@pytest.mark.parametrize("s_dtype", ["bf16", "f32"])
def test_jt_conv1x1_mid_plain_partial_list_matches_jax(s_dtype):
    rng = np.random.RandomState(7 + (s_dtype == "f32"))
    w2 = (rng.standard_normal((MID, MID, 1, 1)) / MID ** 0.5).astype(np.float32)
    w2 = torch.from_numpy(w2).to(torch.bfloat16).float()  # the nets' bf16 kernel
    w2t = ig.transpose_weights(torch.zeros(MID, C, 3, 3), w2, torch.zeros(C, MID, 3, 3))[1]
    B, n = 6, 4
    t = rng.standard_normal((B, MID, HW)).astype(np.float32)
    s1 = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, MID, HW))))).astype(np.float32)
    sdt = torch.bfloat16 if s_dtype == "bf16" else torch.float32
    s1_t = torch.from_numpy(s1).to(sdt)
    idx = torch.from_numpy(rng.permutation(B).astype(np.int32))
    count = torch.tensor([n], dtype=torch.int32)
    # the JAX stage, per live slot: t is indexed by slot, s1 by example
    d2 = _make_wdot("bf16", jnp.asarray(w2t[:, :, 0, 0].numpy()))
    s1_used = s1_t.float().numpy()
    ref = np.stack([_jax(lambda x, s: d2(x) * s, t[k], s1_used[int(idx[k])]) for k in range(n)])

    def run(mode):
        out = torch.full((B, MID, HW), -7.25)
        ig._jt_conv1x1_mid_plain(torch.from_numpy(t), idx, count,
                                 ig.prep_mid_weight(w2t, mode), s1_t, mode, out, H, W)
        assert torch.equal(out[n:], torch.full((B - n, MID, HW), -7.25))  # dead slots
        return out[:n].numpy()

    err, ctrl = rel_norm(run("bf16"), ref), rel_norm(run("f32"), ref)
    assert err <= TOL < ctrl, (err, ctrl)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_backward_solve_prepares_w2t_once(mode):
    """The backward solve hands jt_conv1x1_mid one W2^T for the whole
    solve: in mode bf16 bfloat16, equal to the float32 kernel exactly (the
    nets' weights are bf16 values there), contiguous (mid, mid, 1, 1) with
    w[m][k] at m * mid + k, the kernel's indexing; float32 in mode f32."""
    rng = np.random.RandomState(11)
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    w1, w2, w3 = r(MID, C, 3, 3) * 0.1, r(MID, MID, 1, 1) / MID ** 0.5, r(C, MID, 3, 3) * 0.05
    s = lambda *sh: torch.sigmoid(r(*sh))
    B = 2
    chain = tuple(v.to(dt) for v in (s(B, C, H, W), s(B, MID, H, W), s(B, MID, H, W),
                                     w1, w2, w3))
    seen = []

    def record(t, idx, count, wp, s1, m, out, h, w):
        seen.append(wp)
        return ig._jt_conv1x1_mid_plain(t, idx, count, wp, s1, m, out, h, w)

    ops = dict(ig._PLAIN, jt_conv1x1_mid=record)
    ig._backward_solve(r(B, C, H, W) * 1e-3, chain, ops, threshold=4, eps=1e-10,
                       stall_patience=5, stall_rtol=0.05, mode=mode)
    assert len(seen) > 1 and all(wp[0] is seen[0][0] for wp in seen)
    w = seen[0][0]
    assert w.dtype == ig.mid_weight_dtype(mode) == dt and seen[0][1] is None
    assert w.shape == (MID, MID, 1, 1) and w.is_contiguous()
    assert w.stride() == (MID, 1, 1, 1)
    want = chain[4].float()[:, :, 0, 0].T
    torch.testing.assert_close(w.float()[:, :, 0, 0], want, rtol=0, atol=0)
