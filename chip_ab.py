"""Readings for comparing two trees of the port on one NVIDIA GPU (H100).

    python3 chip_ab.py checks    # chip_smoke.py phases 3, 6, 9 and 15, 14's widths
    python3 chip_ab.py kernels   # device times of the tensor-core products
    python3 chip_ab.py step      # the main path's step and the eval batch
    python3 chip_ab.py sass DIR  # each kernel's SASS against the tree in DIR

Run from the root of a checkout; it drives the port and the chip_smoke.py
found there. To read another commit (a parent) with this commit's checks,
unpack it (``git archive``) and copy this file, chip_smoke.py and
implicit_normalizing_flows_torch/ops/sum_order.py over it; to compare
kernel times, run ``kernels`` in both trees in one call, in turns.

* ``checks``: the whole forward solves (phase 3, on the inputs of an eval
  batch), the whole backward solve and re-attachment VJP (phase 6), the
  whole Neumann chain and final pair (phase 9, in mode bf16 against the
  plain path with fp_conv_mid and fp_conv_in summed exactly) on the real
  inputs of one training step, and the whole merged forward (phase 15, on
  one merged step's), each with its sum-order floors, from the committed checkpoint,
  the inputs captured as chip_smoke.py captures them (every plain version
  forced), then phase 14's narrow widths (the 3x3 tensor-core kernels at
  mid 64, 192 and 384 on NaN-started outputs). Every reading is printed; a
  failed phase is reported and the others still run; the exit code is 1
  if any failed.
* ``step``: the main path, chip_smoke.py's flagship at --mem-eff False
  from the committed checkpoint: 5 settle and 5 timed training steps (host
  clock; their median) and one profiled step (device busy time, the union
  of the kernels' intervals, and the idle share), then one profiled eval
  batch (the same readings); then, from the checkpoint again, on three
  batch seeds, one training step's gradients and one eval batch with each
  solve's nstep summed by block and the forward solves' conv3x3_out
  launches by ladder stage.
* ``kernels``: device time per call (CUDA events around 30 calls, after a
  warm-up) of nc_jt_mid, jt_conv1x1_mid, fp_conv_mid (th2's dswish form),
  rv_conv3x3_out, jt_conv3x3_out (s0 bfloat16, on every slot) and
  rv_conv1x1_mid (h2's swish and t1's dswish forms) in mode bf16 (the two
  3x3 products also at the 16x16 and 8x8 scales' shapes, c 12 and 48,
  beside one cuDNN call of the same product in bf16), and
  conv1x1_mid and lin_conv1x1_mid in tf32 and tf32x, on seeded random
  inputs at the flagship's 32x32 shapes (batch 64, mid 512, c 3; both nets
  for the estimator's two), and rv_conv3x3_out's, jt_conv3x3_out's,
  rv_conv1x1_mid's, conv1x1_mid's and lin_conv1x1_mid's (both outputs)
  errors against their plain versions; then the c -> mid 3x3 products at
  each scale (32x32 c 3, 16x16 c 12, 8x8 c 48): nc_jt_in in mode bf16 with
  s2 bfloat16 and float32 (both nets; error by rel_norm, its outputs being
  rounded to bfloat16) and lin_conv3x3_in in tf32 and tf32x under preact
  (its three outputs), each beside one cuDNN conv2d of the same product (bf16,
  f32); and at each scale the forward solve's conv3x3_in in tf32 and tf32x
  under preact on every slot (beside cuDNN conv2d f32), its conv3x3_out in
  tf32 and tf32x on every slot (net z's residual; beside cuDNN conv2d f32
  with the bias) and the chain's
  nc_jt_out_acc in mode bf16 with s0 bfloat16 and float32 (both nets,
  beside cuDNN conv2d bf16 on both nets' examples; error by rel_norm), the
  final pair's fp_conv_out in mode bf16 on both nets and on the backward's
  four "nets" (beside cuDNN conv2d bf16 on the four nets' examples) and the
  backward solve's jt_conv3x3_in in mode bf16 with s2 bfloat16 on every
  slot (beside cuDNN conv2d bf16), the final pair's fp_conv_in in mode bf16
  on both nets (h1's swish and bias, th1's swish', r2's id; beside cuDNN
  conv2d bf16 on both nets' examples) and the re-attachment's
  rv_conv3x3_in in mode bf16 on every slot (h1's swish and bias, t2's
  alpha -1; beside cuDNN conv2d bf16); then the two reductions:
  broyden_step at nstep 1, 10 and 29 (B 64, D 3072, K 30; PHASE_STEP on
  every slot, a fresh state a call) and fp_tdot at each scale (both nets,
  mid 512), by their device time; then rv_chan_sums in the
  re-attachment's three forms at each scale (M = mid with h; b3 at M = c,
  beside one ``u.sum(dim=(0, 2))``; T0 at M = c with h, base and out), by
  its device time beside its bound, and where the tree has the plan's
  CS_CLUSTERS each form also on each cluster size (1 to 16 CTAs a
  channel), forced. A tree
  from before conv1x1_mid /
  rv_conv1x1_mid / lin_conv1x1_mid / nc_jt_in / lin_conv3x3_in / conv3x3_in
  / nc_jt_out_acc / fp_conv_out / jt_conv3x3_in / fp_conv_in /
  rv_conv3x3_in / conv3x3_out took their tensor-core weights gets its own
  float32 ones
  (and rv_conv1x1_mid and rv_conv3x3_in their slopes as floats;
  fp_conv_out both nets' kernels twice for its four nets).
* ``sass DIR``: every ``csrc/*.cu`` of this tree and of the tree in DIR
  (a parent, unpacked) compiled for sm_90a with the flags of
  ``ops/cuda_build.py``, one nvcc each, all started together; for each
  kernel instantiation (demangled), its registers and spilled bytes in
  both trees and whether its SASS is identical, and the instantiations
  found in one tree only (an instantiation renamed by a template parameter
  appended at its default, ``, 1>``, is read as its older name).

Each run prints the card's name and power limit first. Without a CUDA
device it exits non-zero.
"""
import inspect
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

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
                                                           make_image_eval_step,
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

    def eval_blocks():
        model = cs.build_model(dev)
        draws = Draws(torch.Generator(device=dev).manual_seed(1000 + 99))
        return cs.capture_block_inputs(model, make_image_eval_step(model, imagesize=cs.SIZE),
                                       x_u8, draws)

    failed = 0
    # the same captures as chip_smoke.py's main
    for phase, capture, check in (
            (3, eval_blocks, cs.check_solves),
            (6, lambda: cs.capture_grad_inputs(train_step(True), x_u8, tdraws(99)),
             cs.check_grad_functions),
            (9, lambda: cs.capture_estimator_inputs(train_step(False), x_u8, tdraws(98)),
             cs.check_estimator_functions),
            (15, lambda: cs.capture_block_forward_inputs(train_step(False), x_u8, tdraws(97)),
             cs.check_block_functions),
            (14, lambda: dev, cs.check_conv3x3_in_widths)):
        try:
            check(capture())
        except AssertionError:
            traceback.print_exc()
            cs.log(f"phase {phase} failed")
            failed = 1
    return failed


def kernels():
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    cuda_build.build_all(["fused_solve", "implicit_grad", "estimator", "block_forward"])
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
    w2f = 0.04 * r(mid, mid, 1, 1)
    b2 = 0.1 * r(mid)
    beta = torch.tensor([1.1, 0.9], device=dev)
    o1, o2 = torch.empty(B, mid, HW, device=dev), torch.empty(2 * B, mid, HW, device=dev)
    o3, o4 = (torch.empty(B, c * HW, device=dev) for _ in range(2))
    o5 = torch.empty(B, mid, HW, device=dev)
    o6, o7 = (torch.empty(B, mid, HW, device=dev) for _ in range(2))
    s0 = u(B, c * HW).to(torch.bfloat16)
    base, sub = r(B, c * HW), r(B, c * HW)
    # the 3x3 products at the smaller scales: (c, H, t, th, w1t, s0, base, sub, out)
    small = [(cs, hs, r(B, mid, hs * hs), r(B, mid, hs * hs),
              (0.02 * r(cs, mid, 3, 3)).to(torch.bfloat16).float(),
              u(B, cs * hs * hs).to(torch.bfloat16), r(B, cs * hs * hs), r(B, cs * hs * hs),
              torch.empty(B, cs * hs * hs, device=dev)) for cs, hs in ((12, 16), (48, 8))]
    # the tensors whose form depends on the tree come last, so that every
    # other tensor lies at the same address in both trees
    # a tree before the tensor-core fp_conv_mid takes its kernel in float32
    w2 = w2t if hasattr(ff, "_check_mid") else w2t.float()
    # a tree before the tensor-core conv1x1_mid / rv_conv1x1_mid: float32
    # weights, the slope as a float
    split_w = getattr(fs, "prep_conv1x1_mid", lambda wp, m: wp)
    lin_w = split_w if hasattr(fs, "check_mid_product") else lambda wp, m: wp
    tc_rv = hasattr(ig, "prep_rv_mid_weight")
    rv_w = ig.prep_rv_mid_weight(w2f, "bf16") if tc_rv else ig.prep_weight(w2f, "bf16")
    rv_beta = (lambda i: beta[i:i + 1]) if tc_rv else (lambda i: float(beta[i]))
    times, errs = {}, {}
    times["nc_jt_mid"] = ms(lambda: fc.nc_jt_mid(t2, w2t, s1, "bf16", o2, H, H))
    times["jt_conv1x1_mid"] = ms(lambda: ig.jt_conv1x1_mid(t, idx, cnt, (w2t[0], None), s1[:B],
                                                           "bf16", o1, H, H))
    times["fp_conv_mid (dswish)"] = ms(lambda: ff.fp_conv_mid(t2, t2, w2, None, beta, "dswish",
                                                              "bf16", o2, H, H))
    times["rv_conv3x3_out"] = ms(lambda: ig.rv_conv3x3_out(t, th, 1.1, idx, cnt, (w1t, None),
                                                           "bf16", o3, H, H))
    ig._rv_conv3x3_out_plain(t, th, 1.1, idx, cnt, (w1t, None), "bf16", o4, H, H)
    torch.cuda.synchronize()
    errs["rv_conv3x3_out"] = float((o3 - o4).abs().max() / o4.abs().max())
    jo = lambda f, o: f(t, idx, cnt, (w1t, None), s0, "bf16", base, sub, o, H, H)
    times["jt_conv3x3_out"] = ms(lambda: jo(ig.jt_conv3x3_out, o3))
    jo(ig._jt_conv3x3_out_plain, o4)
    torch.cuda.synchronize()
    errs["jt_conv3x3_out"] = float((o3 - o4).abs().max() / o4.abs().max())
    F = torch.nn.functional
    for cs, hs, ts, ths, ws, s0s, bs, ss, os_ in [(c, H, t, th, w1t, s0, base, sub, o3)] + small:
        tag = f"{hs}x{hs}, c {cs}"
        if hs != H:
            rv = lambda f: f(ts, ths, 1.1, idx, cnt, (ws, None), "bf16", os_, hs, hs)
            jt = lambda f: f(ts, idx, cnt, (ws, None), s0s, "bf16", bs, ss, os_, hs, hs)
            for name, run, kern, plain in (
                    ("rv_conv3x3_out", rv, ig.rv_conv3x3_out, ig._rv_conv3x3_out_plain),
                    ("jt_conv3x3_out", jt, ig.jt_conv3x3_out, ig._jt_conv3x3_out_plain)):
                times[f"{name} {tag}"] = ms(lambda: run(kern))
                got = os_.clone()
                run(plain)
                torch.cuda.synchronize()
                errs[f"{name} {tag}"] = float((got - os_).abs().max() / os_.abs().max())
        tb, wb = ts.view(B, mid, hs, hs).to(torch.bfloat16), ws.to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (the 3x3 products' library call)"] = ms(
            lambda: F.conv2d(tb, wb, padding=1))
    for act, inh, bias, i in (("swish", t, b2, 0), ("dswish", th, None, 1)):
        run = lambda f, o: f(t, inh, cnt, rv_w, bias, 1.0, rv_beta(i), act, "bf16", o, H, H)
        name = f"rv_conv1x1_mid ({act})"
        times[name] = ms(lambda: run(ig.rv_conv1x1_mid, o1))
        run(ig._rv_conv1x1_mid_plain, o5)
        torch.cuda.synchronize()
        errs[name] = float((o1 - o5).abs().max() / o5.abs().max())
    for mode in ("tf32", "tf32x"):
        wp = split_w(fs.prep_weight(w2f, mode), mode)
        run = lambda f, o: f(t, cnt, wp, b2, 1.1, mode, o, H, H)
        name = f"conv1x1_mid ({mode})"
        times[name] = ms(lambda: run(fs.conv1x1_mid, o1))
        run(fs._conv1x1_mid_plain, o5)
        torch.cuda.synchronize()
        errs[name] = float((o1 - o5).abs().max() / o5.abs().max())
    for mode in ("tf32", "tf32x"):
        wp = lin_w(fs.prep_weight(w2f, mode), mode)
        run = lambda f, o, s2: f(t, wp, b2, 1.1, mode, o, s2, H, H)
        name = f"lin_conv1x1_mid ({mode})"
        times[name] = ms(lambda: run(fb.lin_conv1x1_mid, o1, o6))
        run(fb._lin_conv1x1_mid_plain, o5, o7)
        torch.cuda.synchronize()
        errs[name] = max(float((a - b).abs().max() / b.abs().max())
                         for a, b in ((o1, o5), (o6, o7)))
    # the c -> mid 3x3 products at each scale: nc_jt_in (both nets, bf16, s2
    # bfloat16 or float32) and lin_conv3x3_in (tf32, tf32x; preact) beside
    # one cuDNN call of the same product (bf16, f32). A tree from before
    # their tensor-core kernels takes float32 weights.
    tc_in = hasattr(fs, "check_conv3x3_tc")
    for cs, hs in ((c, H), (12, 16), (48, 8)):
        tag, hws = f"{hs}x{hs}, c {cs}", hs * hs
        uu = r(2 * B, cs, hs, hs).to(torch.bfloat16).float()
        w3 = (0.1 * r(2, mid, cs, 3, 3)).to(torch.bfloat16)
        w3k = w3 if tc_in else w3.float()
        oa, ob = (torch.empty(2 * B, mid, hws, device=dev) for _ in range(2))
        for sd in (torch.bfloat16, torch.float32):
            s2 = u(2 * B, mid, hws).to(sd)
            run = lambda f, o: f(uu, w3k, s2, "bf16", o)
            name = f"nc_jt_in (s {'bf16' if sd == torch.bfloat16 else 'f32'}) {tag}"
            times[name] = ms(lambda: run(fc.nc_jt_in, oa))
            run(fc._nc_jt_in_plain, ob)
            torch.cuda.synchronize()
            errs[name] = float((oa - ob).norm() / ob.norm())  # rel_norm: bf16 ties
        ub, wb = uu.to(torch.bfloat16), w3[0]
        times[f"cuDNN conv2d bf16 {tag} (nc_jt_in's library call)"] = ms(
            lambda: F.conv2d(ub, wb, padding=1))
        del oa, ob, s2
        xx, w1 = r(B, cs, hs, hs), 0.1 * r(mid, cs, 3, 3)
        b1 = 0.1 * r(mid)
        outs = [torch.empty(B, mid, hws, device=dev) for _ in range(4)]
        s0s = [torch.empty(B, cs * hws, device=dev) for _ in range(2)]
        for mode in ("tf32", "tf32x"):
            wp = fs.prep_weight(w1, mode)
            wk = fs.prep_conv1x1_mid(wp, mode) if tc_in else wp
            run = lambda f, w, i: f(xx, w, b1, [1.1, 0.9, 1.0], True, mode, outs[2 * i],
                                    outs[2 * i + 1], s0s[i])
            name = f"lin_conv3x3_in ({mode}) {tag}"
            times[name] = ms(lambda: run(fb.lin_conv3x3_in, wk, 0))
            run(fb._lin_conv3x3_in_plain, wp, 1)
            torch.cuda.synchronize()
            errs[name] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in ((outs[0], outs[2]), (outs[1], outs[3]),
                                          (s0s[0], s0s[1])))
        times[f"cuDNN conv2d f32 {tag} (lin_conv3x3_in's library call)"] = ms(
            lambda: F.conv2d(xx, w1, b1, padding=1))
        del outs, s0s
        # the forward solve's conv3x3_in (tf32, tf32x; preact) on every slot:
        # its weights' bf16 halves where it runs on the tensor cores
        tc_solve = hasattr(fs.conv3x3_in, "tc_launches")
        oa, ob = (torch.empty(B, mid, hws, device=dev) for _ in range(2))
        for mode in ("tf32", "tf32x"):
            wp = fs.prep_weight(w1, mode)
            wk = fs.prep_conv1x1_mid(wp, mode) if tc_solve else wp
            run = lambda f, w, o: f(xx, idx, cnt, w, b1, [1.1, 0.9, 1.0], True, mode, o)
            name = f"conv3x3_in ({mode}) {tag}"
            times[name] = ms(lambda: run(fs.conv3x3_in, wk, oa))
            run(fs._conv3x3_in_plain, wp, ob)
            torch.cuda.synchronize()
            errs[name] = float((oa - ob).abs().max() / ob.abs().max())
        del oa, ob
        # the forward solve's conv3x3_out (tf32, tf32x) on every slot, net
        # z's residual base - (W3 t + b3) - sub, beside cuDNN conv2d f32 of
        # the product: W3's bf16 halves in the tile layout where the tree
        # runs it on the tensor cores (a tree before takes the float32 pair)
        prep_out = getattr(fs, "prep_conv3x3_out", lambda wp, m: wp)
        t2o, w3o, b3o = r(B, mid, hws), 0.02 * r(cs, mid, 3, 3), 0.1 * r(cs)
        bo, so_ = r(B, cs * hws), r(B, cs * hws)
        oa, ob = (torch.empty(B, cs * hws, device=dev) for _ in range(2))
        for mode in ("tf32", "tf32x"):
            wk = prep_out(fs.prep_weight(w3o, mode), mode)
            run = lambda f, o: f(t2o, idx, cnt, wk, b3o, mode, bo, -1.0, so_, o, hs, hs)
            name = f"conv3x3_out ({mode}) {tag}"
            times[name] = ms(lambda: run(fs.conv3x3_out, oa))
            run(fs._conv3x3_out_plain, ob)
            torch.cuda.synchronize()
            errs[name] = float((oa - ob).abs().max() / ob.abs().max())
        times[f"cuDNN conv2d f32 {tag} (conv3x3_out's library call)"] = ms(
            lambda: F.conv2d(t2o.view(B, mid, hs, hs), w3o, b3o, padding=1))
        del t2o, bo, so_, oa, ob
        # the chain's nc_jt_out_acc (both nets, bf16, s0 bfloat16 or float32)
        # beside one cuDNN conv2d bf16 of the same product on both nets'
        # examples; W1T in its tile layout where the tree has it
        tt = r(2 * B, mid, hws).to(torch.bfloat16).float()
        w1o = (0.02 * r(2, cs, mid, 3, 3)).to(torch.bfloat16).float()
        w1k = fc.tile_w1t(w1o) if hasattr(fc, "tile_w1t") else w1o
        coef = torch.tensor([0.5, -0.25], device=dev)
        acc0 = r(2 * B, cs * hws)
        uo, ua, up, ap = (torch.empty(2 * B, cs * hws, device=dev) for _ in range(4))
        for sd in (torch.bfloat16, torch.float32):
            s0c = u(2 * B, cs * hws).to(sd)
            run = lambda f, uo_, ao_: f(tt, w1k, s0c, "bf16", coef, 1, uo_.view(2 * B, cs, hs, hs),
                                        ao_, hs, hs)
            name = f"nc_jt_out_acc (s {'bf16' if sd == torch.bfloat16 else 'f32'}) {tag}"
            times[name] = ms(lambda: run(fc.nc_jt_out_acc, uo, ua))
            ua.copy_(acc0)
            ap.copy_(acc0)
            run(fc.nc_jt_out_acc, uo, ua)
            run(fc._nc_jt_out_acc_plain, up, ap)
            torch.cuda.synchronize()
            errs[name] = max(float((a - b).norm() / b.norm()) for a, b in ((uo, up), (ua, ap)))
        tb2, wb2 = tt.view(2 * B, mid, hs, hs).to(torch.bfloat16), w1o[0].to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (nc_jt_out_acc's library call, both nets)"] = ms(
            lambda: F.conv2d(tb2, wb2, padding=1))
        del tt, tb2, uo, ua, up, ap
        # the final pair's fp_conv_out (bf16) on both nets and on the
        # backward's four "nets" (rh1, p_h1 of both nets: float32 inputs)
        # on the two nets' kernels, W1T in its tile layout where the tree
        # has it (a tree before takes both nets' float32 kernels twice)
        tile_fp = "nets" in inspect.signature(ff.fp_conv_out).parameters
        t4 = r(4 * B, mid, hws)
        fo, fp = (torch.empty(4 * B, cs * hws, device=dev) for _ in range(2))
        for nets in (2, 4):
            tn, on_, pn = t4[:nets * B], fo[:nets * B], fp[:nets * B]
            if tile_fp:
                run = lambda f, o, w: f(tn, w, "bf16", o, hs, hs, nets=nets)
                wk = fc.tile_w1t(w1o)
            else:
                run = lambda f, o, w: f(tn, w, "bf16", o, hs, hs)
                wk = torch.cat([w1o] * (nets // 2))
            name = f"fp_conv_out ({nets} nets) {tag}"
            times[name] = ms(lambda: run(ff.fp_conv_out, on_, wk))
            run(ff._fp_conv_out_plain, pn, wk)
            torch.cuda.synchronize()
            errs[name] = float((on_ - pn).abs().max() / pn.abs().max())
        t4b = t4.view(4 * B, mid, hs, hs).to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (fp_conv_out's library call, four nets)"] = ms(
            lambda: F.conv2d(t4b, wb2, padding=1))
        del t4, t4b, fo, fp
        # the backward solve's jt_conv3x3_in (bf16, s2 bfloat16) on every
        # slot, W3T in bfloat16 where the tree runs it on the tensor cores
        tc_jt = "implicit_grad" in cuda_build.LINKED
        uj = r(B, cs, hs, hs)
        w3j = (0.1 * r(mid, cs, 3, 3)).to(torch.bfloat16)
        s2j = u(B, mid, hws).to(torch.bfloat16)
        oa, ob = (torch.empty(B, mid, hws, device=dev) for _ in range(2))
        run = lambda f, w, o: f(uj, idx, cnt, (w, None), s2j, "bf16", o)
        name = f"jt_conv3x3_in (s bf16) {tag}"
        times[name] = ms(lambda: run(ig.jt_conv3x3_in, w3j if tc_jt else w3j.float(), oa))
        run(ig._jt_conv3x3_in_plain, w3j.float(), ob)
        torch.cuda.synchronize()
        errs[name] = float((oa - ob).abs().max() / ob.abs().max())
        ujb = uj.to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (jt_conv3x3_in's library call)"] = ms(
            lambda: F.conv2d(ujb, w3j, padding=1))
        del uj, ujb, s2j, oa, ob
        # the final pair's fp_conv_in (bf16, both nets, each with its own
        # slope and bias) in its three forms and the re-attachment's
        # rv_conv3x3_in (bf16, every slot) in its two, beside one cuDNN
        # conv2d bf16 each; the kernels in bfloat16 where the tree runs them
        # on the tensor cores (a tree before takes float32 kernels, and
        # rv_conv3x3_in its slope as a float)
        tc_aff = "conv3x3_in_tc_affine" in (cuda_build.CSRC_DIR / "conv3x3_in_tc.cu").read_text()
        hf, ef = r(2 * B, cs, hs, hs), r(2 * B, cs, hs, hs)
        w1f = (0.1 * r(2, mid, cs, 3, 3)).to(torch.bfloat16)
        b1f, bnf = 0.1 * r(2, mid), torch.tensor([1.1, 0.9], device=dev)
        xr, w1r, b1r = r(B, cs, hs, hs), (0.1 * r(mid, cs, 3, 3)).to(torch.bfloat16), 0.1 * r(mid)
        oa, ob = (torch.empty(2 * B, mid, hws, device=dev) for _ in range(2))
        w1k = w1f if tc_aff else w1f.float()
        for what, args in (("h1, swish", (hf, None, w1k, b1f, bnf, "swish")),
                           ("th1, dswish", (ef, hf, w1k, None, bnf, "dswish")),
                           ("r2, id", (ef, None, w1k, None, None, "id"))):
            run = lambda f, o: f(*args, "bf16", o)
            name = f"fp_conv_in ({what}) {tag}"
            times[name] = ms(lambda: run(ff.fp_conv_in, oa))
            run(ff._fp_conv_in_plain, ob)
            torch.cuda.synchronize()
            errs[name] = float((oa - ob).abs().max() / ob.abs().max())
        hfb = hf.to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (fp_conv_in's library call, both nets)"] = ms(
            lambda: F.conv2d(hfb, w1f[0], padding=1))
        oa, ob = oa[:B], ob[:B]
        wr = (w1r if tc_aff else w1r.float(), None)
        beta_r = bnf[:1] if tc_aff else float(bnf[0])
        for what, args in (("h1, swish", (xr, idx, cnt, wr, b1r, 1.0, beta_r, "swish")),
                           ("t2, alpha -1", (xr, idx, cnt, wr, None, -1.0,
                                             None if tc_aff else 0.0, "id"))):
            run = lambda f, o: f(*args, "bf16", o)
            name = f"rv_conv3x3_in ({what}) {tag}"
            times[name] = ms(lambda: run(ig.rv_conv3x3_in, oa))
            run(ig._rv_conv3x3_in_plain, ob)
            torch.cuda.synchronize()
            errs[name] = float((oa - ob).abs().max() / ob.abs().max())
        xrb = xr.to(torch.bfloat16)
        times[f"cuDNN conv2d bf16 {tag} (rv_conv3x3_in's library call)"] = ms(
            lambda: F.conv2d(xrb, w1r, padding=1))
        del hf, ef, hfb, xr, xrb, oa, ob
    reductions(times, errs, r)
    for name, v in times.items():
        print(f"kernel {name}{'' if ', c ' in name else ' 32x32'}: {v:.4f} ms", flush=True)
    for name, v in errs.items():
        print(f"{name} max_rel_err against its plain version {v:.3e}", flush=True)
    return 0


def reductions(times, errs, r):
    """Device time (chip_smoke.py's device_ms, the profiler's) of
    broyden_step (PHASE_STEP on every slot of B 64, D 3072, K 30, at
    nstep 1, 10 and 29, a fresh copy of the state a call, the wrapper's
    zeroing of the next count included) and fp_tdot (both nets' 128
    examples, mid 512, at each scale) into ``times``, and their errors
    against their plain versions into ``errs``."""
    import chip_smoke as cs
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    dev = torch.device("cuda")
    B, D, K, reps = 64, 3072, 30, 10
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
    io = torch.zeros(B, dtype=torch.int32, device=dev)
    co = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(eps=1e-3, cap=K, patience=5, rtol=0.05, guard_eps=3e-3, newton=True)
    for nk in cs.STEP_NSTEPS:
        st0 = cs.broyden_state(B, D, K, nk, nk, dev)
        name = f"broyden_step (nstep {nk}) D {D}, c 3"
        # device time (the profiler's, as chip_smoke.py's phase 2: the
        # host's launch gaps exceed the kernel), a fresh state a call
        copies = [{k: v.clone() for k, v in st0.items()} for _ in range(4 * reps + 1)]
        it = iter(copies)
        times[name] = cs.device_ms(
            lambda i: fs.broyden_step(fs.PHASE_STEP, idx, cnt, io, co, next(it), **kw), reps)
        stp = {k: v.clone() for k, v in st0.items()}
        fs._broyden_step_plain(fs.PHASE_STEP, idx, cnt, io, co, stp, **kw)
        torch.cuda.synchronize()
        errs[name] = max(cs.rel_err(copies[0][k].float(), stp[k].float()) for k in stp)
        del copies, it, stp
    beta = torch.tensor([1.1, 0.9], device=dev)
    for hs in (32, 16, 8):
        rr, hh, tt = (r(2 * B, 512, hs * hs) for _ in range(3))
        out, ref = (torch.empty(2 * B, device=dev) for _ in range(2))
        name = f"fp_tdot {hs}x{hs}, c {3 * 1024 // (hs * hs)}"
        times[name] = cs.device_ms(lambda i: ff.fp_tdot(rr, hh, tt, beta, out), 30)
        ff._fp_tdot_plain(rr, hh, tt, beta, ref)
        torch.cuda.synchronize()
        errs[name] = float((out - ref).abs().max() / ref.abs().max())
        del rr, hh, tt
    chan_sums(times, errs, r)


def chan_sums(times, errs, r):
    """Device time of rv_chan_sums in the re-attachment's three forms at
    each scale (batch 64; M = mid 512 with h and dbeta; M = c, b3's sums of
    u, beside one u.sum call; M = c, net x's T0 with h, dbeta, base and
    out), each with its bound (the bytes moved once at the card's peak
    rate), into ``times``, and their errors against the plain version (the
    largest over the outputs, relative to each one's largest entry) into
    ``errs``; where the tree has CS_CLUSTERS, each form also on each of
    its cluster sizes, forced."""
    import chip_smoke as cs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    dev = torch.device("cuda")
    B, mid = 64, 512
    for hs in (32, 16, 8):
        HW, c = hs * hs, 3 * 1024 // (hs * hs)
        forms = []
        for M, form in ((mid, "M = mid, h"), (c, "b3"), (c, "T0, h, base, out")):
            t = r(B, M, HW)
            h = None if form == "b3" else r(B, M, HW)
            base = r(B, M, HW) if form.startswith("T0") else None
            forms.append((form, M, t, h, base))
        for form, M, t, h, base in forms:
            outs = []
            for _ in range(2):
                sums = torch.empty(M, device=dev)
                db = None if h is None else torch.empty(M, device=dev)
                out = None if base is None else torch.empty_like(t)
                outs.append((sums, db, out))
            alpha = -1.0 if form == "b3" else 1.0
            run = lambda f, o: f(t, h, 0.9, alpha, base, *o)
            name = f"rv_chan_sums ({form}) {hs}x{hs}, c {c}"
            nbytes = 4 * (sum(v.numel() for v in (t, h, base) if v is not None)
                          + sum(v.numel() for v in outs[0] if v is not None))
            times[name] = cs.device_ms(lambda i: run(ig.rv_chan_sums, outs[0]), 30)
            times[f"bound of {name}"] = 1e3 * nbytes / cs.PEAK_BYTES
            if hasattr(ig, "CS_CLUSTERS"):  # every cluster size, forced
                keep = ig.CS_CLUSTERS
                try:
                    for k in keep:
                        ig.CS_CLUSTERS = (k,)
                        times[f"{name} on {k} CTAs a channel"] = cs.device_ms(
                            lambda i: run(ig.rv_chan_sums, outs[0]), 30)
                finally:
                    ig.CS_CLUSTERS = keep
            run(ig._rv_chan_sums_plain, outs[1])
            torch.cuda.synchronize()
            errs[name] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(*outs) if a is not None)
            if form == "b3":
                times[f"u.sum(dim=(0, 2)) {hs}x{hs}, c {c} (b3's library call)"] = \
                    cs.device_ms(lambda i: t.sum(dim=(0, 2)), 30)
        del forms, t, h, base, outs


def solver_counts(dev, x_u8s):
    """For each batch of ``x_u8s``, from the committed checkpoint: one
    --mem-eff False training step's gradients and one eval batch, with
    each forward and backward solve's nstep summed over its examples (by
    block, in call order) and the forward solves' conv3x3_out launches by
    precision stage (the ladder's tf32 / tf32x / f32), which a kernel's
    sum order moves as it moves which iteration dips under the tolerance;
    and the re-attachments' rv_chan_sums launches by width (M = mid or c)."""
    import chip_smoke as cs
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import (adam, linear_warmup,
                                                           make_image_eval_step,
                                                           make_image_train_step)

    seen = {"forward": [], "backward": [], "stages": {}, "chan_sums": {}}

    def rec(name, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            seen[name].append(int(out.nstep.sum()))
            return out
        return run

    conv_out = fs.KERNELS["conv3x3_out"]

    def counted(*a, **k):
        seen["stages"][a[5]] = seen["stages"].get(a[5], 0) + 1
        return conv_out(*a, **k)

    chan_sums = ig.KERNELS["rv_chan_sums"]

    def by_width(t, *a, **k):
        width = f"M {t.shape[1]}"
        seen["chan_sums"][width] = seen["chan_sums"].get(width, 0) + 1
        return chan_sums(t, *a, **k)

    model = cs.build_model(dev, grad_in_forward=False)
    opt = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
    train = make_image_train_step(model, opt, ema_decay=0.999, n_lipschitz_iters=None,
                                  imagesize=cs.SIZE)
    evaluate = make_image_eval_step(model, imagesize=cs.SIZE)
    fs.KERNELS["conv3x3_out"] = counted
    ig.KERNELS["rv_chan_sums"] = by_width
    try:
        with cs.patched([(implicit_block, "fused_broyden_solve",
                          rec("forward", implicit_block.fused_broyden_solve)),
                         (implicit_block, "fused_backward_solve",
                          rec("backward", implicit_block.fused_backward_solve))]):
            for i, x_u8 in enumerate(x_u8s):
                for what, run in (
                        ("train step gradients", lambda: train.grads(x_u8, Draws(
                            torch.Generator(device=dev).manual_seed(3000 + i)))),
                        ("eval batch", lambda: evaluate(x_u8, Draws(
                            torch.Generator(device=dev).manual_seed(4000 + i))))):
                    seen.update(forward=[], backward=[], stages={}, chan_sums={})
                    run()
                    torch.cuda.synchronize()
                    cs.log(f"batch seed {i + 1} {what}: forward nstep by block {seen['forward']} "
                           f"(total {sum(seen['forward'])}), backward nstep by block "
                           f"{seen['backward']} (total {sum(seen['backward'])}), conv3x3_out "
                           f"launches by stage {dict(sorted(seen['stages'].items()))}, "
                           f"rv_chan_sums launches by width {seen['chan_sums']}")
    finally:
        fs.KERNELS["conv3x3_out"] = conv_out
        ig.KERNELS["rv_chan_sums"] = chan_sums


def step():
    import chip_smoke as cs
    from implicit_normalizing_flows_torch.data import synthetic_structured
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import (adam, linear_warmup,
                                                           make_image_eval_step,
                                                           make_image_train_step)

    dev = torch.device("cuda")
    cuda_build.build_all(list(cs.SOURCES))
    x_u8 = torch.from_numpy(synthetic_structured(cs.BATCH, 3, cs.SIZE, cs.SIZE, seed=1))
    tdraws = lambda i: Draws(torch.Generator(device=dev).manual_seed(2000 + i))
    model = cs.build_model(dev, grad_in_forward=False)
    opt = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
    train = make_image_train_step(model, opt, ema_decay=0.999, n_lipschitz_iters=None,
                                  imagesize=cs.SIZE)
    cs.train_steps(train, x_u8, tdraws, 0, cs.SETTLE_STEPS)
    timed = sorted(t for _, t in cs.train_steps(train, x_u8, tdraws, cs.SETTLE_STEPS,
                                                cs.TIMED_STEPS))
    cs.log(f"--mem-eff False step: median {timed[len(timed) // 2]:.1f} ms")
    cs.profile_train_step(train, x_u8, tdraws(cs.SETTLE_STEPS + cs.TIMED_STEPS))
    draws = lambda i: Draws(torch.Generator(device=dev).manual_seed(1000 + i))
    evaluate = make_image_eval_step(model, imagesize=cs.SIZE)
    evaluate(x_u8, draws(0))  # warm-up
    cs.profile_batch(model, evaluate, x_u8, draws(0))
    del model, train, evaluate
    solver_counts(dev, [torch.from_numpy(synthetic_structured(cs.BATCH, 3, cs.SIZE, cs.SIZE,
                                                              seed=s)) for s in (1, 2, 3)])
    return 0


def _sass_of(tree, src, out):
    """{instantiation: (registers, spilled bytes, SASS lines)} of one
    source of ``tree``, compiled to a cubin in ``out``."""
    from implicit_normalizing_flows_torch.ops import cuda_build

    tool = lambda name: str(Path(cuda_build.nvcc_path()).parent / name)
    cubin = out / f"{abs(hash(tree))}_{src}.cubin"
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
           "-o", str(cubin), f"{tree}/implicit_normalizing_flows_torch/csrc/{src}.cu"]
    return subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), cubin, tool


def _read_sass(proc, cubin, tool):
    err = proc.communicate()[1]
    assert proc.returncode == 0, err
    demangle = lambda n: re.sub(r"\((int|bool|unsigned int)\)", "", subprocess.run(
        [tool("cu++filt"), n], capture_output=True, text=True).stdout.strip()).split("(")[0]
    use, cur = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        cur = m[1] if m else cur
        m = re.search(r"(\d+) bytes spill stores", line) or re.search(r"Used (\d+) registers",
                                                                       line)
        if m and cur:
            use.setdefault(cur, []).append(int(m[1]))
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            spill, regs = (use.get(m[1], []) + [None, None])[:2]
            cur = funcs.setdefault(demangle(m[1]), (regs, spill, []))[2]
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?);", line)
        if m and cur is not None:
            cur.append(re.sub(r"\s+", " ", m[1]))
    return funcs


def sass():
    """Registers, spills and SASS identity of every kernel instantiation of
    this tree against the tree in sys.argv[2]."""
    other = sys.argv[2]
    srcs = sorted(p.stem for p in Path("implicit_normalizing_flows_torch/csrc").glob("*.cu"))
    out = Path(tempfile.mkdtemp())
    jobs = {(t, s): _sass_of(t, s, out) for t in (other, ".") for s in srcs
            if Path(f"{t}/implicit_normalizing_flows_torch/csrc/{s}.cu").exists()}
    got = {k: _read_sass(*v) for k, v in jobs.items()}
    same = differ = 0
    for src in srcs:
        old, new = got.get((other, src), {}), got.get((".", src), {})
        # an instantiation that gained a trailing template argument is read
        # against its old name: of several such, the one with the old SASS
        short = lambda n: re.sub(r", \w+>$", ">", n)
        renamed = {}
        for n in sorted(new):
            o = short(n)
            if n in old or o not in old or o in new:
                continue
            if o not in renamed or new[n][2] == old[o][2]:
                renamed[o] = n
        for o, n in renamed.items():
            new[o] = new.pop(n)
        for name in sorted(set(old) | set(new)):
            a, b = old.get(name), new.get(name)
            if a is None or b is None:
                print(f"{src}: only in {'this tree' if a is None else other}: {name}")
                continue
            same += a[2] == b[2]
            differ += a[2] != b[2]
            print(f"{src}: {'identical' if a[2] == b[2] else 'DIFFERS'} {name}: registers "
                  f"{a[0]} -> {b[0]}, spilled bytes {a[1]} -> {b[1]}, {len(a[2])} -> "
                  f"{len(b[2])} instructions")
    print(f"SASS identical for {same} instantiations, different for {differ}")
    return 0


def main():
    modes = {"checks": checks, "kernels": kernels, "step": step, "sass": sass}
    nargs = 3 if sys.argv[1:2] == ["sass"] else 2
    if not torch.cuda.is_available() or len(sys.argv) != nargs or sys.argv[1] not in modes:
        print("usage, on a CUDA device: python3 chip_ab.py checks|kernels|step|sass DIR",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    t0 = time.perf_counter()
    rc = modes[sys.argv[1]]()
    print(f"{sys.argv[1]}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
