"""The precision probe (``ops/precision_probe.py``) on the CPU: on its
operands the port's plain split products agree with the JAX package's
``_make_dot`` (``implicit_normalizing_flows_tpu/ops/fused_solve.py``), and
the two controls that ``chip_smoke.py`` holds the ``tf32`` kernels against
(phases 2 and 14) read above the limit of those phases.

Layouts: a 1x1 conv's channels and a 3x3 conv's taps, at the flagship's
channel counts cut to a small width (batch 2, 8x8): c 3 -> mid (the odd
channel left zero), c 12 -> mid, mid -> mid (1x1), mid -> c 3.

* The port's plain ``tf32`` / ``tf32x`` product (``fused_solve._mconv`` on
  ``prep_weight``) against ``_make_dot("tf32")`` / ``_make_dot("tf32x")``
  on the im2col matrix: the same exact products summed in another order,
  so within 1e-5 relative (every entry is positive, 2.5 to 13; measured
  here: equal to the bit).
* Against plain ``tf32``: plain ``f32`` (which keeps lo*lo) and the
  10-bit-mantissa emulation of native TF32 (``round_tf32`` on both
  operands, then plain ``f32``) each read above 1e-4 by the phases' measure
  (max error over the largest entry, at least 1; measured here: 1.0e-3 to
  1.7e-3 and 1.1e-1), and ``f32`` does so on every entry (3.4e-4 or more):
  a kernel that ran either would fail the chip's check. Plain ``tf32x``
  reads above it against ``tf32`` too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.ops.fused_solve import _make_dot
from implicit_normalizing_flows_torch.ops import fused_solve as fs
from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32, tf32_probe

B, HW, MID = 2, 8, 32
LIMIT = 1e-4  # chip_smoke.py phase 2's limit (and phase 14's in tf32)
LAYOUTS = {"3x3 c3->mid": (3, MID, 3), "3x3 c12->mid": (12, MID, 3),
           "1x1 mid->mid": (MID, MID, 1), "3x3 mid->c3": (MID, 3, 3)}


def probe(name, seed=0):
    cin, cout, k = LAYOUTS[name]
    x, w = tf32_probe(B, cin, cout, HW, HW, k, seed)
    return x, w, k // 2


def im2col(x, k):
    """(cin*k*k, B*H*W) columns in the OIHW flattening of the kernel."""
    p = k // 2
    xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
    cols = [xp[:, :, dy:dy + HW, dx:dx + HW] for dy in range(k) for dx in range(k)]
    cols = np.stack(cols, axis=2)  # (B, cin, k*k, H, W)
    return cols.transpose(1, 2, 0, 3, 4).reshape(x.shape[1] * k * k, -1)


def plain(x, w, pad, mode):
    return fs._mconv(torch.from_numpy(x), fs.prep_weight(torch.from_numpy(w), mode), mode, pad)


def rel_err(a, b):
    """chip_smoke.py's phase-2 measure: max error over max(max|b|, 1)."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


@pytest.mark.parametrize("mode", ["tf32", "tf32x"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_split_matches_jax(name, mode):
    x, w, pad = probe(name)
    got = plain(x, w, pad, mode)
    with jax.disable_jit():  # XLA:CPU jits no bf16 x bf16 -> f32 dot
        ref = _make_dot(mode)(jnp.asarray(w.reshape(w.shape[0], -1)),
                              jnp.asarray(im2col(x, w.shape[-1])))
    ref = np.asarray(ref).reshape(w.shape[0], B, HW, HW).transpose(1, 0, 2, 3)
    assert float(np.abs(ref).min()) > 1.0  # every entry positive and large
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_probe_controls_read_above_limit(name):
    x, w, pad = probe(name, seed=3)
    tf32 = plain(x, w, pad, "tf32")
    f32 = plain(x, w, pad, "f32")
    native = fs._mconv(round_tf32(torch.from_numpy(x)), (round_tf32(torch.from_numpy(w)), None),
                       "f32", pad)
    tf32x = plain(x, w, pad, "tf32x")
    readings = {"f32": rel_err(f32, tf32), "native tf32": rel_err(native, tf32),
                "tf32x": rel_err(tf32x, tf32)}
    assert all(v > LIMIT for v in readings.values()), readings
    # every entry: the lo*lo terms that tf32 drops exceed the limit
    floor = float(tf32.abs().max().clamp(min=1.0))
    assert float((f32 - tf32).abs().min()) / floor > LIMIT
    # the split is the one the error model names: tf32x keeps lo*lo, so it
    # sits within float32 rounding of the exact result; tf32 does not
    exact = torch.nn.functional.conv2d(torch.from_numpy(x).double(),
                                       torch.from_numpy(w).double(), padding=pad)
    assert rel_err(tf32x.double(), exact) < 1e-6 < rel_err(tf32.double(), exact)


def test_round_tf32_keeps_ten_bits():
    v = torch.tensor([1.0 + 2.0**-10 + 2.0**-11, 1.0 + 2.0**-11 - 2.0**-20,
                      -(1.0 + 3 * 2.0**-11), 1.5 + 2.0**-16])
    want = torch.tensor([1.0 + 2.0**-9, 1.0, -(1.0 + 2.0**-9), 1.5])
    torch.testing.assert_close(round_tf32(v), want, rtol=0, atol=0)
