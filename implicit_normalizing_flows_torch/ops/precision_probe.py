"""A precision probe: conv operands on which the split precision modes
read apart from float32 and from native TF32.

The forward-solve and linearisation kernels run mode ``tf32`` as the JAX
kernels' 3-pass bf16 split (``hi*hi + hi*lo + lo*hi``, ``_make_dot`` of
``implicit_normalizing_flows_tpu/ops/fused_solve.py``) and ``tf32x`` as the
4-pass one (``+ lo*lo``). On real data the split sits within about 2^-16 of
float32, below the noise of summing in another order, so a kernel that ran
plain float32, or the tensor cores' native TF32 (10 mantissa bits), would
pass a comparison with its plain version. On these operands it cannot.

Each input channel carrying ``a`` is paired with one carrying ``bf16(a)``,
and the pair is weighted ``[w, -bf16(w)]`` on every tap, so the hi*hi terms
cancel and each pair contributes exactly

    w a - bf16(w) bf16(a) = h_w l_a + l_w h_a + l_w l_a

with ``h = bf16(v)`` and ``l = v - h``. The values are built so that every
term is exact: ``|h|`` is a bfloat16 in (1, 2), ``l = (64 j + r) 2^-16``
with j in {2, 3} and r in [8, 28], below half a bfloat16 ulp of ``h`` (so
``bf16(v) = h``) and itself a bfloat16 (so the split's lo is ``l``). The
activations are positive, their hi part one value per example and channel
pair; a weight's hi part is one magnitude per output and channel pair whose
sign alternates over the taps of a 3x3 kernel, while its lo part stays
positive. So the hi*hi terms that a kernel sums before a pair's partner
channel cancels them (a kernel that sums channel by channel reaches the
partner 9 taps later) cancel each other tap by tap, and the lo terms are
rounded against at most one of them: the sum order's error stays near
2e-5 of the largest entry with one channel pair (c = 3) and falls with
more, while on every output entry:

* ``tf32`` drops ``l_w l_a``, which is positive on every tap: about 1e-3
  of the entry, against float32 (exact) and ``tf32x`` (which keeps it);
* native TF32 rounds each ``v`` to a multiple of 2^-10 in (1, 2), which
  moves every weight down (by ``r 2^-16`` or ``(64 - r) 2^-16``) and every
  activation down by ``r 2^-16``: about 1e-1 of the entry.

An odd channel count leaves the last channel zero. The activations are
scaled by a power of two (exact) so that an interior entry is about 8, above
the floor of 1 that the checks' relative errors divide by.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tf32_probe", "round_tf32"]


def tf32_probe(batch, cin, cout, height, width, ksize, seed=0):
    """``(x, w)`` numpy float32 of a ``ksize`` x ``ksize`` conv ``cin ->
    cout``: x (batch, cin, height, width), w (cout, cin, ksize, ksize),
    made from ``seed`` as the module describes."""
    rng = np.random.RandomState(seed)
    pairs = cin // 2

    def split(shape, hi_shape):
        hi = 1.0 + rng.randint(1, 128, size=hi_shape) / 128.0
        lo = (64 * rng.randint(2, 4, size=shape) + rng.randint(8, 29, size=shape)) * 2.0**-16
        return hi * np.ones(shape), lo

    ha, la = split((batch, pairs, height, width), (batch, pairs, 1, 1))
    hw, lw = split((cout, pairs, ksize, ksize), (cout, pairs, 1, 1))
    hw = hw * (-1.0) ** np.arange(ksize * ksize).reshape(ksize, ksize)  # hi's sign by tap
    # an interior entry: pairs * ksize^2 products l_w h_a of about 2.7e-3 *
    # 1.5 (and as many h_w l_a on a 1x1 kernel, whose hi is positive)
    terms = max(1, pairs * ksize * ksize) * (2 if ksize == 1 else 1)
    scale = 2.0 ** max(0, int(round(np.log2(8.0 / (terms * 4e-3)))))
    x = np.zeros((batch, cin, height, width))
    x[:, 0:2 * pairs:2], x[:, 1:2 * pairs:2] = (ha + la) * scale, ha * scale
    w = np.zeros((cout, cin, ksize, ksize))
    w[:, 0:2 * pairs:2], w[:, 1:2 * pairs:2] = hw + lw, -hw
    return x.astype(np.float32), w.astype(np.float32)


def round_tf32(t):
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``): the operand that native TF32
    products see, emulated with integer ops so that no global TF32 flag is
    touched. Finite values only."""
    if t.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
