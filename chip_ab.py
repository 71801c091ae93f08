"""Readings for comparing two trees of the port on one NVIDIA GPU (H100).

    python3 chip_ab.py checks    # chip_smoke.py phases 6 and 9
    python3 chip_ab.py kernels   # device times of four bf16 products

Run from the root of a checkout; it drives the port and the chip_smoke.py
found there. To read another commit (a parent) with this commit's checks,
unpack it (``git archive``) and copy this file, chip_smoke.py and
implicit_normalizing_flows_torch/ops/sum_order.py over it; to compare
kernel times, run ``kernels`` in both trees in one call, in turns.

* ``checks``: the whole backward solve and re-attachment VJP (phase 6, with
  the sum-order floors) and the whole Neumann chain and final pair (phase
  9, in mode bf16 against the plain path with fp_conv_mid summed exactly)
  on the real inputs of one training step from the committed checkpoint.
  Every reading is printed; a failed phase is reported and the other still
  runs; the exit code is 1 if any failed.
* ``kernels``: device time per call (CUDA events around 30 calls, after a
  warm-up) of nc_jt_mid, jt_conv1x1_mid, fp_conv_mid (th2's dswish form)
  and rv_conv3x3_out in mode bf16, on seeded random inputs at the
  flagship's 32x32 shapes (batch 64, mid 512, c 3; both nets for the
  estimator's two), and rv_conv3x3_out's error against its plain version.

Each run prints the card's name and power limit first. Without a CUDA
device it exits non-zero.
"""
import os
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, os.getcwd())


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def checks():
    import chip_smoke as cs
    from implicit_normalizing_flows_torch.data import synthetic_structured
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import (adam, linear_warmup,
                                                           make_image_train_step)

    dev = torch.device("cuda")
    cuda_build.build_all(list(cs.SOURCES))
    x_u8 = torch.from_numpy(synthetic_structured(cs.BATCH, 3, cs.SIZE, cs.SIZE, seed=1))
    tdraws = lambda i: Draws(torch.Generator(device=dev).manual_seed(2000 + i))

    def train_step(grad_in_forward):
        opt = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
        return make_image_train_step(cs.build_model(dev, grad_in_forward), opt,
                                     ema_decay=0.999, n_lipschitz_iters=None,
                                     imagesize=cs.SIZE)

    failed = 0
    # the same captures as chip_smoke.py's main
    for phase, capture, check, gif, seed in (
            (6, cs.capture_grad_inputs, cs.check_grad_functions, True, 99),
            (9, cs.capture_estimator_inputs, cs.check_estimator_functions, False, 98)):
        try:
            check(capture(train_step(gif), x_u8, tdraws(seed)))
        except AssertionError:
            traceback.print_exc()
            cs.log(f"phase {phase} failed")
            failed = 1
    return failed


def kernels():
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    cuda_build.build_all(["implicit_grad", "estimator"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)

    def ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    B, mid, c, H = 64, 512, 3, 32
    HW = H * H
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
    t, th = r(B, mid, HW), r(B, mid, HW)
    t2, s1 = r(2 * B, mid, HW), u(2 * B, mid, HW).to(torch.bfloat16)
    w2t = (0.04 * r(2, mid, mid, 1, 1)).to(torch.bfloat16)
    w1t = (0.02 * r(c, mid, 3, 3)).to(torch.bfloat16).float()
    beta = torch.tensor([1.1, 0.9], device=dev)
    # a tree before the tensor-core fp_conv_mid takes its kernel in float32
    w2 = w2t if hasattr(ff, "_check_mid") else w2t.float()
    o1, o2 = torch.empty(B, mid, HW, device=dev), torch.empty(2 * B, mid, HW, device=dev)
    o3, o4 = (torch.empty(B, c * HW, device=dev) for _ in range(2))
    times = {
        "nc_jt_mid": ms(lambda: fc.nc_jt_mid(t2, w2t, s1, "bf16", o2, H, H)),
        "jt_conv1x1_mid": ms(lambda: ig.jt_conv1x1_mid(t, idx, cnt, (w2t[0], None), s1[:B],
                                                       "bf16", o1, H, H)),
        "fp_conv_mid (dswish)": ms(lambda: ff.fp_conv_mid(t2, t2, w2, None, beta, "dswish",
                                                         "bf16", o2, H, H)),
        "rv_conv3x3_out": ms(lambda: ig.rv_conv3x3_out(t, th, 1.1, idx, cnt, (w1t, None),
                                                       "bf16", o3, H, H)),
    }
    ig._rv_conv3x3_out_plain(t, th, 1.1, idx, cnt, (w1t, None), "bf16", o4, H, H)
    torch.cuda.synchronize()
    err = float((o3 - o4).abs().max() / o4.abs().max())
    for name, v in times.items():
        print(f"kernel {name} 32x32 bf16: {v:.4f} ms", flush=True)
    print(f"rv_conv3x3_out max_rel_err against its plain version {err:.3e}", flush=True)
    return 0


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2 or sys.argv[1] not in (
            "checks", "kernels"):
        print("usage, on a CUDA device: python3 chip_ab.py checks|kernels", file=sys.stderr)
        return 1
    print(card(), flush=True)
    t0 = time.perf_counter()
    rc = checks() if sys.argv[1] == "checks" else kernels()
    print(f"{sys.argv[1]}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
