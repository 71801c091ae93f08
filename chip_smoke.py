"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels (csrc/fused_solve.cu, csrc/implicit_grad.cu,
     csrc/estimator.cu, csrc/broyden_update.cu and csrc/block_forward.cu,
     with the units linked beside them (ops/cuda_build.py LINKED) and the
     headers they include, one nvcc each, in parallel, with the compiler's
     register and spill report);
  2. each forward-solve kernel against its plain PyTorch version at the
     CIFAR-10 flagship's shapes (all three scales, batch 64, the committed
     checkpoint's weights, the blocks' real inputs, captured from an eval
     batch with the plain forward solve forced): max error and device
     time, with the plain version's time, the least time the card could take
     (bound) and one PyTorch library call's time for comparison; then the
     precision probe (ops/precision_probe.py) at each scale's shapes: each
     conv kernel in tf32 against its plain version in tf32 and against two
     controls that must read above the limit, the plain version in f32 and
     native TF32 emulated (both operands rounded to 10 mantissa bits), and
     in tf32x against plain tf32x and the control plain tf32; conv1x1_mid,
     conv3x3_in and conv3x3_out run tf32 and tf32x on the tensor cores
     (csrc/mma_gemm.cuh, csrc/conv3x3_in_tc.cuh and csrc/conv3x3_out_tc.cuh,
     the bf16 split's 3 or 4 passes) and are also timed in tf32x;
     conv3x3_in and conv3x3_out are also read on a partial permuted active
     list, their dead slots (examples) untouched; broyden_step (a
     thread-block cluster a live example, csrc/broyden_step.cu) in its
     three phases on states with 1, 10 and 29 planes written, on every slot
     and on half the slots under a permuted list (ist and the next list
     equal to the plain version's, the other examples untouched), timed at
     each;
  3. the whole fused forward solve against its plain version, per scale and
     mode, each run beside its sum-order floors (the plain solve with
     conv1x1_mid, conv3x3_in, both, conv3x3_out, all three, or
     broyden_step summed exactly, or broyden_step in its kernel's order,
     ops/sum_order.py, against the plain solve: max|dz|, |d nstep|
     counts, flags that differ), every reading printed before any limit is
     checked;
  4. the flagship evaluation (bits/dim of 64 structured-synthetic images,
     seed 1) through the port's entry points, with the forward-solve
     kernels' launch counts over that run, a profiled batch (which must
     record the tensor-core kernels of conv1x1_mid, conv3x3_in and
     conv3x3_out as often as their wrappers launched them in the split
     modes, and broyden_step's cluster kernel as often as it launched), and
     the plain path's bpd on the same draws;
  5. each implicit-gradient kernel (backward solve, re-attachment VJP)
     against its plain version at the flagship's shapes, on the blocks' real
     inputs and cotangents captured from one training step, in bf16 and f32:
     max error, device time, plain time, bound, share of the bound, bytes/s
     and a library call's time; in bf16 also the control, the plain version
     in mode f32 on the same inputs against the bf16 one, which must lie
     above the limit. rv_wgrad is read at every weight gradient the
     re-attachment launches (dW2, dW3, dW1 with and without preact),
     rv_conv1x1_mid in both its forms (h2, swish; t1, swish'),
     rv_conv3x3_in in both (h1, [swish] and bias; net z's t2, alpha -1),
     rv_chan_sums in its three (b2 / b1 and their slopes at M = mid; b3's
     sums of u, beside one u.sum call; net x's t0 with d_x, at M = c) and
     at HW 49 and on tensors off 16-byte alignment (M 48 and 512, batch 4,
     outputs started as NaN; csrc/chan_sums.cu's single-float path), and
     jt_conv3x3_in, jt_conv1x1_mid, jt_conv3x3_out, rv_conv3x3_out,
     rv_conv1x1_mid and rv_conv3x3_in also on a partial active list (count
     B/2, a permuted idx; rv_conv1x1_mid takes the count alone), whose dead
     slots (examples) must stay bitwise untouched. In mode bf16 all seven
     run on the tensor cores (jt_conv1x1_mid and rv_conv1x1_mid on
     csrc/mma_gemm.cuh, rv_wgrad on csrc/wgrad_tc.cuh, rv_conv3x3_out and
     jt_conv3x3_out on csrc/conv3x3_out_tc.cuh, jt_conv3x3_in and
     rv_conv3x3_in on csrc/conv3x3_in_tc.cuh);
  6. the whole backward solve and the whole re-attachment VJP against their
     plain versions, per scale and mode, each rounding mode with its
     control and its sum-order floors (the plain path with jt_conv3x3_in,
     jt_conv1x1_mid, jt_conv3x3_out, the last two or all three; or with
     rv_wgrad, rv_conv3x3_out, rv_conv1x1_mid, rv_conv3x3_in or
     rv_chan_sums summed exactly, or rv_chan_sums in its cluster kernel's
     order: ops/sum_order.py), every reading
     printed before any limit is checked; phases 5 and 6 read inputs
     captured from a training step with every plain version forced, so that
     a floor measures its product and not how the port's kernels moved its
     inputs;
  7. flagship training steps (batch 64, --mem-eff True) from the committed
     checkpoint with Adam, warmup, power iteration and EMA as the benchmark
     sets them: 5 settle and 5 timed steps with the forward-solve and
     implicit-gradient kernels' launch counts over them, a time breakdown
     of one step and a profiled step, then one step's loss and gradients
     (cosine and norm ratio per tensor) with the plain versions forced
     against the kernels' on the same state and draws;
  8. each estimator kernel of --mem-eff False (the Neumann chain's three
     stages, the final pair's five kernels and its weight gradient through
     the re-attachment's rv_wgrad) against its plain version on
     the real inputs of one --mem-eff False step, at each scale (and, at
     32x32, the first block's nets without preact), in bf16 and f32: max
     error, and in bf16 device time, plain time, bound, the share of the
     bound and the bytes/s achieved, a library call's time and the control
     (the plain version in mode f32 on the same inputs, which must read
     above the limit); the bf16 1x1 products nc_jt_mid and fp_conv_mid run
     on the tensor cores (csrc/mma_gemm.cuh), and so do the chain's 3x3
     products nc_jt_in (c -> mid, csrc/conv3x3_in_tc.cuh) and
     nc_jt_out_acc (mid -> c, csrc/conv3x3_out_tc.cuh), both also read on
     float32 s, and the final pair's fp_conv_out (mid -> c, the same
     kernel) and fp_conv_in (c -> mid, the float64 form in the header of
     nc_jt_in's kernel);
     fp_conv_mid is read with each act (id on the backward's four "nets",
     swish, dswish), fp_conv_in in each form (h1, th1, r2) and fp_conv_out
     on both nets and on the backward's four; the inputs of phases 8 and 9
     come from a step with
     every plain version forced;
  9. the whole Neumann chain (the step's n_power) and the whole final pair
     (T, d_h and every gradient) against their plain versions, per scale
     and mode, by rel_norm with controls; in bf16 the chain beside its
     sum-order floors (the plain chain with nc_jt_in, nc_jt_out_acc or both
     summed exactly against the plain chain), printed before any limit is
     checked, and the final pair is held
     against the plain path with fp_conv_mid and fp_conv_in summed exactly
     (FINAL_TOL's comment), beside its reading against the plain path and
     the sum-order floors of fp_conv_mid, fp_conv_in, rv_wgrad and
     fp_conv_out, and T beside fp_tdot's (T with it summed exactly, or in
     its cluster kernel's order, csrc/tdot.cu);
 10. the main path: flagship training steps at the users' default
     --mem-eff False (grad_in_forward=False) from the checkpoint, as phase
     7: 5 settle and 5 timed steps with every kernel's launch count over
     them (all must be > 0), peak memory, a time breakdown (forward solves,
     chains, final-pair primal and backward, backward solves,
     re-attachments, update, rest), a profiled step (which must record each
     tensor-core kernel, TC_ROUTES, and each cluster-split reduction,
     REDUCE_ROUTES, as many times as its wrapper launched
     it there, the instantiations fp_conv_mid and rv_conv1x1_mid share as
     often as the two launched them together, and none of the CUDA-core
     instantiations they replaced; a step whose record lost launches is
     profiled again, up to ROUTE_ATTEMPTS times; the profiled steps of
     phases 7 and 16 are held to the same), and the step
     with all five plain versions forced against the kernels';
 11. the generic Broyden solver's rank-1 update (csrc/broyden_update.cu)
     against its plain version at the tabular POWER recipe's shapes (B 1000
     forward K 30 and backward K 4, B 4000 evaluation, at columns 0, 3 and
     K - 1) on the real inputs of one block of the phase-13 model after its
     warm-up (the columns past a solve's last one zero, as the solver
     leaves them), and on synthetic ones at BSDS300's width (D 63) and with
     inactive rows and a zero denominator (the scrub): each output's max
     error relative to its largest entry, device time, plain time and
     bound;
 12. the whole generic forward and backward solves (bf16 and f32
     linearisation) on every block of that model, kernel against plain:
     roots, converged and protective-break flags, iteration counts;
 13. the tabular main path: the POWER recipe of run_tabular.sh at full
     width (20 blocks of two 6-128-128-128-128-6 sin MLPs, coeff 0.99,
     eps 1e-5, batch 1000, Adam at linear warmup, clip, power iteration,
     EMA) from a seeded init on the synthetic POWER stand-in: 110 warm-up
     steps (so the forward solves leave the one-iteration regime; the mean
     forward iteration count must end above 2; phases 11 and 12 run on
     this state), 5 settle and 10 timed steps with the update kernel's
     launch count over the timed ones (> 0), peak memory, a time breakdown
     (forward solves, estimators, backward solves, re-attachments, update,
     rest), a profiled step, one step with the plain version forced against
     the kernel's, and one evaluation batch of 4000 (brute-force log-det),
     kernel NLL against plain;
 14. each kernel of the merged block forward (IMNF_FUSED_BLOCK=1,
     csrc/block_forward.cu: the linearisation variants of the solve's first
     two convs, and the chain's three stages with float32 derivative
     factors) against its plain version on the real inputs of one merged
     training step (every scale merged for the capture), per scale, in the
     main path's mode (and the linearisation kernels in tf32x; both write
     swish and swish', both on the tensor cores in both: lin_conv3x3_in on
     csrc/conv3x3_in_tc.cuh, lin_conv1x1_mid on csrc/mma_gemm.cuh) and in
     bf16 and f32, with controls, device time, plain time, bound and a
     library call's time; and the linearisation kernels on phase 2's
     precision probe; then the 3x3 tensor-core kernels (c -> mid: nc_jt_in,
     jt_conv3x3_in, fp_conv_in and rv_conv3x3_in in bf16, lin_conv3x3_in
     and conv3x3_in in tf32 and
     tf32x; mid -> c: conv3x3_out in tf32 and tf32x, nc_jt_out_acc and
     fp_conv_out in bf16) at mid 64, 192
     and 384 on seeded random inputs
     at each scale, their outputs started as NaN so that a channel chunk
     left unwritten fails; the inputs of phases 14 and 15 come from a
     merged step with every plain version forced, and phase 14's chain
     inputs from the plain solve's linearisation;
 15. the whole merged forward against its plain version, per scale and
     mode (roots, flags, iteration counts, both accs, with a control), each
     run beside its sum-order floors (the plain forward with lin_conv1x1_mid,
     lin_conv3x3_in or both, or the solve's conv3x3_in or conv3x3_out,
     summed exactly, or conv3x3_out in its kernel's order, against the
     plain forward, as phase 3), and the one-net
     Neumann chain (fused_neumann_chain) against its plain version;
 16. the merged path: flagship training at --mem-eff False with
     IMNF_FUSED_BLOCK=1 from the checkpoint (the 32x32 and 16x16 blocks
     merged, the 8x8 ones split), as phase 10: 5 settle and 5 timed steps
     with every conv kernel's launch count over them (all > 0), peak
     memory, a breakdown (merged forwards, final terms, the 8x8 blocks'
     split parts, backward solves, re-attachments, update, rest), a
     profiled step and the step with every plain version forced; phase 10's
     median beside its own;
 17. sampling (run right after phase 4, on the eval model's checkpoint
     weights): ImplicitFlow.inverse of 64 latents tau 0.8 * N(0, 1), whose
     block solves are the forward solve's kernels with the nets' roles
     swapped (net z embeds z, net x is solved, eps 1e-5). Each scale's
     first block's inverse input is captured from one inverse with every
     plain version forced; on it, as phases 2 and 3 read the forward: the
     conv kernels with net x's weights in tf32, tf32x and f32 (timed, and
     on a partial permuted list), broyden_step on the state its plain
     solve reached at its sixth step, the precision probe with its
     activations scaled to these operands' range (a power of two), the
     f32 and native-TF32 controls on the real operands (printed), and the
     whole inverse solves at phase 3's eps-1e-5 configurations beside their
     sum-order floors, held to phase 3's limits; then one warm-up and 3
     timed batches with the four kernels' launch counts over them (each >
     0), peak memory, each block's nstep, protective breaks and the Banach
     fallback's time, a profiled batch (busy time, idle share, the
     tensor-core routes held), the round trip forward(inverse(z)) on both
     paths, and the images against the plain path's within 1e-3 beside the
     floor (SAMPLE_TOL's comment).
 18. the Armijo line search (IMNF_LINE_SEARCH=1; line_search on
     csrc/line_search.cu, a thread-block cluster a live example, three
     steps around the trial residuals, which the solves' own conv kernels
     evaluate on device-side lists), in two parts. Right after phase 6, on
     the checkpoint's blocks: the whole forward (phase 2's inputs, eps
     1e-6, tf32 with the ladder), inverse (phase 17's, eps 1e-5) and bf16
     backward (phase 5's) solves with the search, newton_init True and
     False, kernels against plain beside their floors (the plain path with
     the search's sums exact, or in its kernel's order), every reading
     printed first, then held at phases 3 / 17 and 6's limits; each solve's
     tally of examples that failed the test and took the quadratic, halved
     or full step (the newton_init=False solves must take a shortened
     step); then line_search against its plain version and its kernel's
     order on each scale's state captured mid-solve (every slot, half the
     slots permuted, NaN / inf residuals injected), each step timed. After
     phase 13, the paths end to end under the search, each against its
     plain path on the same draws: one eval batch and one sampling batch
     (profiled), 3 settle and 3 timed --mem-eff False steps (as phase 10,
     the profiled step's routes with line_search's), one merged step and 3
     tabular steps from phase 13's state.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernels as JSON (the forward solve's four with their launches
in phase 17 as sample_launches; line_search with its launches in phase 18's
paths), the line before that the card's name and power limit. Without a
CUDA device it exits non-zero and prints no result.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "experiments", "cifar10_long_r4", "bench_ckpt.npz")
TPU_SOLVE = "implicit_normalizing_flows_tpu/ops/fused_solve.py:1921"
TPU_BWD = "implicit_normalizing_flows_tpu/ops/fused_solve.py:930"
TPU_REATTACH = "implicit_normalizing_flows_tpu/ops/fused_solve.py:1226"
TPU_CHAIN = "implicit_normalizing_flows_tpu/ops/fused_chain.py:333"
TPU_FINAL = "implicit_normalizing_flows_tpu/ops/fused_solve.py:1689"
TPU_UPDATE = "implicit_normalizing_flows_tpu/ops/pallas_kernels.py:69"
TPU_BLOCK = "implicit_normalizing_flows_tpu/ops/fused_solve.py:1814"
SOURCES = {"fused_solve": "implicit_normalizing_flows_torch/csrc/fused_solve.cu",
           "implicit_grad": "implicit_normalizing_flows_torch/csrc/implicit_grad.cu",
           "estimator": "implicit_normalizing_flows_torch/csrc/estimator.cu",
           "broyden_update": "implicit_normalizing_flows_torch/csrc/broyden_update.cu",
           "block_forward": "implicit_normalizing_flows_torch/csrc/block_forward.cu"}
# H100 SXM published peaks (dense): HBM bytes/s, FP32 (CUDA cores) and bf16
# tensor-core FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
PASSES = {"f32": 1, "bf16": 1, "tf32": 3, "tf32x": 4}
BATCH, SIZE = 64, 32
EVAL_BATCHES = 3
SETTLE_STEPS, TIMED_STEPS = 5, 5
# Limits of phase 5 (max|kernel - plain| over max|plain|) and phase 6
# (rel_norm). A kernel and its plain version round the same operands (an
# operand computed on load, swish or swish', is the plain version's to the
# bit) and sum exact products, so they differ by the order of float32 sums
# (up to 65,536 terms), in every mode. Whole functions chain kernels: an
# intermediate one float32 ulp apart rounds to another bfloat16 where it
# sits on a tie, which moves a few entries. Each rounding mode's limit lies
# below its control, the plain version in mode f32 on the same inputs
# against the mode's: what a kernel that skipped the rounding would read.
# tf32's three-pass split sits within about 2^-16 of float32, below the sum
# order's noise on real inputs: there its control reads under its limit,
# which bounds only that noise. The precision probe (phases 2 and 14,
# ops/precision_probe.py) gives the split modes their controls: on its
# operands the lo*lo terms that tf32 drops read about 9e-4 of an entry and
# native TF32's lost mantissa bits about 1e-1, against SPLIT_TOL.
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-5}
SPLIT_TOL = 1e-4  # phase 2's limit (float32 sums in another order)
PROBE_BATCH = 16
BWD_TOL = {"bf16": 2e-4}
REATTACH_TOL = {"bf16": 2e-5, "tf32": 2e-5}
# Phase 6 prints each function's sum-order floor beside its reading: the
# plain path with one product summed exactly (ops/sum_order.py) against the
# plain path. A kernel that sums in another order than the plain version
# (the tensor cores, by 64-k partials) reads near it, so a limit below it
# would fail any such kernel. No limit is held to a floor.
NO_ROUNDING = ("rv_wgrad_reduce", "rv_chan_sums", "rv_chan_sums (b3)",  # sums only: no mode
               "rv_chan_sums (T0)",
               "fp_tdot", "fp_second")
# The chain's stages round their outputs to bfloat16 in mode bf16: an
# output a few float32 ulps apart (sum order over up to 4,608 products)
# that sits near a tie rounds to the next bfloat16, one ulp (2^-8) of that
# entry. Phase 8 holds them by rel_norm over the whole output at
# ROUNDED_TOL: such entries moved it by up to 7.0e-5 (16x16), a skipped
# rounding (the control) by 1.3e-3 or more.
ROUNDED_OUTPUT = ("nc_jt_in", "nc_jt_in (float32 s)", "nc_jt_mid", "nc_jt_out_acc",
                  "nc_jt_out_acc (float32 s)")
ROUNDED_TOL = 2e-4
# Phase 9 (rel_norm). The chain re-rounds every stage of every term, so
# the ties' moves are carried on through the series (measured up to 9.7e-5
# against controls of 1.3e-3 and more). The final pair rounds no output:
# its errors are the sum order's, its least control (T, a sum over every
# pixel and channel, where the bf16 rounding averages out) 5.9e-5.
CHAIN_TOL = {"f32": 1e-5, "bf16": 5e-4}
FINAL_TOL = {"f32": 1e-5, "bf16": 1e-5}
# The final pair's d_h and weight gradients are small differences of large
# terms, so the order of fp_conv_mid's float32 sums moves them by up to
# 1.4e-5, and the order of fp_conv_in's (5a: h1, th1 and r2, which feed
# every term) by up to 1.8e-5 (c48, x.w1): the plain path (cuDNN's order)
# lies that far from the same path with those bf16 products summed exactly
# (in float64, rounded once; ops/sum_order.py). Against the plain path,
# FINAL_TOL would pass only a kernel that sums in cuDNN's order. So in mode
# bf16 phase 9 holds the kernel path against the plain path with fp_conv_mid
# and fp_conv_in summed exactly, which no order favours, and prints beside
# it the readings against the plain path and against the plain path with
# fp_conv_mid alone exact (the reference until fp_conv_in's floor was read
# above FINAL_TOL), and the floors: the plain path against the reference
# with fp_conv_mid alone exact, that against the reference (fp_conv_in's),
# and the plain path with rv_wgrad's products (5f) summed exactly against
# the plain path (far below FINAL_TOL: the weight gradients' sums do not
# cancel that way). The control, the plain path in mode f32, is read
# against the same reference. Mode f32 is held against the plain path.
# Phases 11-13: the tabular POWER recipe. The update kernel and its plain
# version compute the same float32 formulas with sums in another order
# (over D <= 63 and K <= 30 terms): UPDATE_TOL is max error over the
# output's largest entry. The warm-up is cut from 200 to 110 steps to keep
# the script's time in bounds (a step is host-bound, about a second): with
# the zero-initialised last layers every forward solve converges in one
# iteration at first, and the mean forward nstep of this seeded run on an
# H100 read 2.05 at step 80, 2.75 at step 100 and 3.00 from step 120.
# Phase 15 (rel_norm over acc - eps). The kernels' and the plain version's
# solves differ by float sums in another order, so net z's linearisation
# point, the best iterate, moves by that noise; in the main path's mode the
# chain runs in bf16 and re-rounds every stage (phase 9's ties), its control
# the f32 chain. The one-net chain is phase 9's chain on one net.
BLOCK_ACC_TOL = {"f32": 1e-4, "tf32": 5e-4}
# The wrappers that run on the tensor cores (mode bf16; conv1x1_mid and
# lin_conv1x1_mid in tf32 / tf32x), each with its kernel's profiler name,
# source and instruction: the 1x1 products on mma_gemm.cuh's
# tc_conv1x1_kernel<NP, ST, EPI, IN, PASSES> (nc_jt_mid EPI_SCALE_RND 3,
# jt_conv1x1_mid EPI_SCALE 2, both IN_ID 0; fp_conv_mid EPI_AFFINE 1 with
# IN_ID, IN_SWISH or IN_DSWISH; rv_conv1x1_mid EPI_AFFINE 1 with IN_SWISH or
# IN_DSWISH; all PASSES 1; conv1x1_mid EPI_SWISH 0 and lin_conv1x1_mid
# EPI_SWISH_LIN 4, IN_ID, PASSES 3 / 4 at NP 64), rv_wgrad on wgrad_tc.cuh's
# product (after its two bf16 pre-passes, wgrad_prep_kernel), and
# rv_conv3x3_out and jt_conv3x3_out on conv3x3_out_tc.cuh's
# conv3x3_out_tc_kernel<TW, NT, IN, EPI, ST> (IN_DSWISH 2 with C3_STORE 0,
# IN_ID 0 with C3_RESID 1), and nc_jt_in and lin_conv3x3_in on
# conv3x3_in_tc.cuh's conv3x3_in_tc_kernel<TW, EPI, PASSES, ST>
# (EPI_SCALE_RND 3 with PASSES 1; EPI_SWISH_LIN 4 with PASSES 3 / 4), and
# conv3x3_in on the same kernel (EPI_SWISH 0 with PASSES 3 / 4) and
# conv3x3_out on conv3x3_out_tc_kernel (IN_ID 0 with C3_SOLVE 4, float,
# PASSES 3 / 4) and
# nc_jt_out_acc on conv3x3_out_tc_kernel (IN_ID 0 with C3_CHAIN 2), and
# fp_conv_out on conv3x3_out_tc_kernel (IN_ID 0 with C3_FINAL 3) and
# jt_conv3x3_in on conv3x3_in_tc_kernel (EPI_SCALE 2 with PASSES 1), and
# rv_conv3x3_in on conv3x3_in_tc_kernel (EPI_AFFINE 1 with PASSES 1), and
# fp_conv_in on the same header's float64 form, conv3x3_in_dmma_kernel<TW>
# (mma.sync f64 on the bf16 operands). A
# profiled training step (and the eval profile, for conv1x1_mid and
# conv3x3_in) must record each as many times as its wrapper launched it
# there (conv1x1_mid, lin_conv1x1_mid, lin_conv3x3_in, conv3x3_in,
# conv3x3_out: their launches in the split modes, TC_COUNT), and none of the
# CUDA-core
# instantiations they replaced:
# conv_gemm_kernel<MODE_BF16 1, SRC 1, IN_ID, EPI_AFFINE | EPI_SCALE |
# EPI_SCALE_RND> and <1, 1, IN_SWISH | IN_DSWISH, EPI_AFFINE>,
# conv_gemm_kernel<MODE_TF32 2 | MODE_TF32X 3, 1, IN_ID, EPI_SWISH |
# EPI_SWISH_LIN>, conv3x3_out_kernel<1, IN_DSWISH, ...>, conv3x3_out_kernel<1,
# IN_ID, float | __nv_bfloat16, false> (the float32 form was fp_conv_out's;
# the forward solve's conv3x3_out makes it only in mode bf16, which no
# default path runs), every wgrad_kernel<1, ...>, conv_gemm_kernel<1, SRC 0, IN_ID,
# EPI_SCALE_RND>, conv_gemm_kernel<2 | 3, 0, IN_ID | IN_SWISH,
# EPI_SWISH_LIN>, conv3x3_out_kernel<1, IN_ID, float | __nv_bfloat16, true>
# (the chain's), conv_gemm_kernel<2 | 3, 0, IN_ID | IN_SWISH, EPI_SWISH>
# (the solve's conv3x3_in), conv_gemm_kernel<1, 0, IN_ID, EPI_SCALE>
# (jt_conv3x3_in's) and conv_gemm_kernel<1, 0, IN_ID | IN_SWISH | IN_DSWISH,
# EPI_AFFINE> (fp_conv_in's and rv_conv3x3_in's) and conv3x3_out_kernel<2 |
# 3, IN_ID, float, false> (the solve's conv3x3_out in tf32 / tf32x), which
# only those stages made. fp_conv_mid
# and rv_conv1x1_mid share the swish and swish' instantiations (SHARED_TC):
# the profiler records them under one name, so a step must record them as
# often as the two wrappers launched them together.
TC_ROUTES = {
    "nc_jt_mid": (re.compile(r"tc_conv1x1_kernel<\d+, ?[\w:]+, ?3, ?0, ?1>"),
                  "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh", "wgmma bf16"),
    "jt_conv1x1_mid": (re.compile(r"tc_conv1x1_kernel<\d+, ?[\w:]+, ?2, ?0, ?1>"),
                       "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh", "wgmma bf16"),
    "fp_conv_mid": (re.compile(r"tc_conv1x1_kernel<\d+, ?float, ?1, ?[012], ?1>"),
                    "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh", "wgmma bf16"),
    "rv_conv1x1_mid": (re.compile(r"tc_conv1x1_kernel<\d+, ?float, ?1, ?[12], ?1>"),
                       "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh", "wgmma bf16"),
    "conv1x1_mid": (re.compile(r"tc_conv1x1_kernel<64, ?float, ?0, ?0, ?[34]>"),
                    "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh",
                    "wgmma bf16, the 3- or 4-pass split of tf32 / tf32x; f32 on CUDA cores"),
    "lin_conv1x1_mid": (re.compile(r"tc_conv1x1_kernel<64, ?float, ?4, ?0, ?[34]>"),
                        "implicit_normalizing_flows_torch/csrc/mma_gemm.cuh",
                        "wgmma bf16, the 3- or 4-pass split of tf32 / tf32x; f32 and bf16 on "
                        "CUDA cores"),
    "rv_wgrad": (re.compile(r"wgrad_tc_kernel<"),
                 "implicit_normalizing_flows_torch/csrc/wgrad_tc.cuh", "wgmma bf16"),
    "rv_conv3x3_out": (re.compile(r"conv3x3_out_tc_kernel<\d+, ?\d+, ?2, ?0,"),
                       "implicit_normalizing_flows_torch/csrc/conv3x3_out_tc.cuh",
                       "mma.sync bf16"),
    "jt_conv3x3_out": (re.compile(r"conv3x3_out_tc_kernel<\d+, ?\d+, ?0, ?1,"),
                       "implicit_normalizing_flows_torch/csrc/conv3x3_out_tc.cuh",
                       "mma.sync bf16"),
    "nc_jt_in": (re.compile(r"conv3x3_in_tc_kernel<\d+, ?3, ?1,"),
                 "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh", "mma.sync bf16"),
    "lin_conv3x3_in": (re.compile(r"conv3x3_in_tc_kernel<\d+, ?4, ?[34],"),
                       "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh",
                       "mma.sync bf16, the 3- or 4-pass split of tf32 / tf32x; f32 and bf16 on "
                       "CUDA cores"),
    "conv3x3_in": (re.compile(r"conv3x3_in_tc_kernel<\d+, ?0, ?[34],"),
                   "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh",
                   "mma.sync bf16, the 3- or 4-pass split of tf32 / tf32x; f32 and bf16 on CUDA "
                   "cores"),
    "nc_jt_out_acc": (re.compile(r"conv3x3_out_tc_kernel<\d+, ?\d+, ?0, ?2,"),
                      "implicit_normalizing_flows_torch/csrc/conv3x3_out_tc.cuh",
                      "mma.sync bf16"),
    "fp_conv_out": (re.compile(r"conv3x3_out_tc_kernel<\d+, ?\d+, ?0, ?3,"),
                    "implicit_normalizing_flows_torch/csrc/conv3x3_out_tc.cuh", "mma.sync bf16"),
    "jt_conv3x3_in": (re.compile(r"conv3x3_in_tc_kernel<\d+, ?2, ?1,"),
                      "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh", "mma.sync bf16"),
    "fp_conv_in": (re.compile(r"conv3x3_in_dmma_kernel<"),
                   "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh",
                   "mma.sync f64 on bf16 operands, float64 sums"),
    "rv_conv3x3_in": (re.compile(r"conv3x3_in_tc_kernel<\d+, ?1, ?1,"),
                      "implicit_normalizing_flows_torch/csrc/conv3x3_in_tc.cuh",
                      "mma.sync bf16; f32 and tf32 on CUDA cores"),
    "conv3x3_out": (re.compile(r"conv3x3_out_tc_kernel<\d+, ?\d+, ?0, ?4, ?float, ?[34]>"),
                    "implicit_normalizing_flows_torch/csrc/conv3x3_out_tc.cuh",
                    "mma.sync bf16, the 3- or 4-pass split of tf32 / tf32x; f32 and bf16 on CUDA "
                    "cores"),
}
# The four cluster-split reductions (csrc/cluster_reduce.cuh): broyden_step
# on broyden_cluster_kernel<VPT, DZ_TAKEN> (csrc/broyden_step.cu), fp_tdot on
# tdot_split_kernel (csrc/tdot.cu), rv_chan_sums on
# chan_sums_split_kernel<VEC, HAS_H, HAS_OUT> (csrc/chan_sums.cu) and, under
# IMNF_LINE_SEARCH=1 (phase 18), line_search on line_search_kernel<VPT>
# (csrc/line_search.cu). A
# profiled run must record each as many times as its wrapper launched it,
# and never the one-block-an-example (or a-channel) kernels they replaced
# (broyden_step_kernel, tdot_kernel, chan_sums_kernel: REPLACED_SIMT).
REDUCE_ROUTES = {
    "broyden_step": (re.compile(r"broyden_cluster_kernel<"),
                     "implicit_normalizing_flows_torch/csrc/broyden_step.cu",
                     "a thread-block cluster a live example, sums through distributed shared "
                     "memory"),
    "fp_tdot": (re.compile(r"tdot_split_kernel"), "implicit_normalizing_flows_torch/csrc/tdot.cu",
                "a thread-block cluster an example, sums through distributed shared memory"),
    "rv_chan_sums": (re.compile(r"chan_sums_split_kernel<"),
                     "implicit_normalizing_flows_torch/csrc/chan_sums.cu",
                     "a thread-block cluster a channel, sums through distributed shared "
                     "memory"),
    "line_search": (re.compile(r"line_search_kernel<"),
                    "implicit_normalizing_flows_torch/csrc/line_search.cu",
                    "a thread-block cluster a live example, sums through distributed shared "
                    "memory"),
}
ROUTES = {**TC_ROUTES, **REDUCE_ROUTES}
TC_SPLIT = "conv1x1_mid (tensor cores)"  # launch_counts()'s key of those launches
TC_LIN = "lin_conv1x1_mid (tensor cores)"
TC_LIN3 = "lin_conv3x3_in (tensor cores)"
TC_IN = "conv3x3_in (tensor cores)"
TC_OUT = "conv3x3_out (tensor cores)"
# the count a route is held to, where not its wrapper's
TC_COUNT = {"conv1x1_mid": TC_SPLIT, "lin_conv1x1_mid": TC_LIN, "lin_conv3x3_in": TC_LIN3,
            "conv3x3_in": TC_IN, "conv3x3_out": TC_OUT}
SHARED_TC = [("fp_conv_mid", "rv_conv1x1_mid")]
# run only in --mem-eff False's estimator
ESTIMATOR_ONLY = ("nc_jt_in", "nc_jt_mid", "nc_jt_out_acc", "fp_conv_mid", "fp_conv_out",
                  "fp_conv_in", "fp_tdot")
# run only in the merged forward (IMNF_FUSED_BLOCK=1)
MERGED_ONLY = ("lin_conv3x3_in", "lin_conv1x1_mid")
REPLACED_SIMT = re.compile(r"conv_gemm_kernel<1, ?1, ?0, ?[123],|conv_gemm_kernel<1, ?1, ?[12], ?1,"
                           r"|conv_gemm_kernel<[23], ?1, ?0, ?[04],|conv3x3_out_kernel<1, ?2,"
                           r"|conv3x3_out_kernel<1, ?0, ?(float|__nv_bfloat16), ?false>"
                           r"|wgrad_kernel<1,|conv_gemm_kernel<1, ?0, ?0, ?3,"
                           r"|conv_gemm_kernel<[23], ?0, ?[01], ?4,"
                           r"|conv3x3_out_kernel<1, ?0, ?(float|__nv_bfloat16), ?true>"
                           r"|conv_gemm_kernel<[23], ?0, ?[01], ?0,"
                           r"|conv_gemm_kernel<1, ?0, ?0, ?2,"
                           r"|conv_gemm_kernel<1, ?0, ?[012], ?1,"
                           r"|conv3x3_out_kernel<[23], ?0, ?float, ?false>"
                           r"|\bbroyden_step_kernel\b|\btdot_kernel\b|\bchan_sums_kernel<")
ROUTE_ATTEMPTS = 3  # profiled steps that may show the routes (train_path)
TAB_DIM, TAB_BATCH, TAB_EVAL_BATCH = 6, 1000, 4000
TAB_WARMUP, TAB_SETTLE, TAB_TIMED = 110, 5, 10
UPDATE_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def _kernel_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_busy(prof):
    """(summed kernel time, busy time, span) in ms of the device work that
    ``prof`` recorded: the busy time is the union of the kernels' intervals,
    the span runs from the first kernel's start to the last one's end. The
    sum exceeds the union where kernels overlap (or the record does), so the
    idle share is read from the union."""
    from torch.autograd import DeviceType

    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    union, end = 0.0, -math.inf
    for t0, t1 in iv:
        if t1 > end:
            union += t1 - max(t0, end)
            end = t1
    span = end - iv[0][0] if iv else 0.0
    return sum(t1 - t0 for t0, t1 in iv) / 1e3, union / 1e3, span / 1e3


def _self_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) / 1e3


def is_port_kernel(name):
    """A kernel of csrc/ (by its symbol in the profiler)."""
    return any(k in name for k in ("imnf::", "broyden_cluster", "wgrad", "chan_sums",
                                   "tdot_split", "second_kernel", "broyden_update",
                                   "line_search"))


TIMINGS = {"runs": 0, "dropped": 0}  # device_ms's profiled runs, and those that dropped launches


def device_ms(fn, reps=10):
    """Mean device time per call of fn(i), i < reps, from the CUDA kernels
    it launches (torch.profiler), so host launch latency and syncs between
    calls are not counted: each kernel's mean time per recorded launch
    times its launches per call (recorded launches over reps, rounded, at
    least 1). The profiler now and then drops launches from its record,
    which a plain sum over reps would read as a shorter time, and now and
    then records no kernel at all: such a run is repeated, and after three
    the calls are timed with CUDA events instead (launch gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)  # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        TIMINGS["runs"] += 1
        TIMINGS["dropped"] += any(e.count % reps for e in events)
        ms = sum(_self_ms(e) / e.count * max(1, round(e.count / reps)) for e in events)
        if ms > 0:
            return ms
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    log("  (the profiler recorded no kernel three times: CUDA events)")
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, macs, mode):
    """(ms, 'bytes'|'operations'): the larger of moving the bytes at the HBM
    rate and doing the products at the peak rate of their type (f32 on the
    CUDA cores; the split modes as bf16 tensor-core passes)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (2 * macs / PEAK_F32 if mode == "f32"
             else 2 * macs * PASSES[mode] / PEAK_BF16)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


def build_model(dev, grad_in_forward=True):
    """The flagship (run_cifar10.sh's recipe; --mem-eff True, or False with
    grad_in_forward=False) on the committed checkpoint."""
    from implicit_normalizing_flows_torch.layers import LogitTransform
    from implicit_normalizing_flows_torch.models import ImplicitFlow
    from implicit_normalizing_flows_torch.training import (load_jax_checkpoint,
                                                           load_npz_tree)

    model = ImplicitFlow((BATCH, 3, SIZE, SIZE), n_blocks=[2, 2, 2],
                         intermediate_dim=512, init_layer=LogitTransform(0.05),
                         actnorm=True, coeff=0.9, vnorms="2222", n_dist="poisson",
                         kernels="3-1-3", preact=True, sn_atol=1e-3, sn_rtol=1e-3,
                         n_exact_terms=10, neumann_grad=True,
                         grad_in_forward=grad_in_forward, device=dev)
    load_jax_checkpoint(model, load_npz_tree(CKPT))
    return model


def capture_block_inputs(model, step, x_u8, draws):
    """The input of each scale's last implicit block in one eval run with the
    plain forward solve forced (plain_versions), so that the inputs, and
    the floors phase 3 reads on them, do not move with the port's kernels
    (each scale's input comes out of the earlier blocks' solves)."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock

    seen, hooks = {}, []
    for s, scale in enumerate(model.transforms):
        block = [m for m in scale if isinstance(m, ImplicitBlock)][-1]
        hooks.append(block.register_forward_pre_hook(
            lambda mod, args, s=s: seen.__setitem__(s, (mod, args[0].detach().clone()))))
    try:
        with patched(plain_versions(False)):
            step(x_u8, draws)
    finally:
        for h in hooks:
            h.remove()
    return [seen[s] for s in sorted(seen)]


def check_kernels(blocks, mode="tf32", net="nnet_z", extra=("tf32x",), states=None,
                  probe_range=False, phase="phase 2"):
    """Phase 2: every kernel vs its plain version at each scale's shapes
    (the conv kernels with the weights of the block's ``net``, in ``mode``
    and in each mode of ``extra``, timed, and on a partial permuted list;
    broyden_step on the mid-solve states of :func:`check_broyden_step`, or
    with ``states`` on each scale's captured state, :func:`check_step_state`;
    the precision probe, with ``probe_range`` its activations scaled by a
    power of two to each operand's range and its errors read relative to
    the largest entry, unclamped, so that they repeat the unscaled probe's
    unless a kernel depends on its operands' exponent)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    rows, probe_fails = {}, []
    for s, (block, x) in enumerate(blocks):
        B, c, H, W = x.shape
        HW, D, dev = H * W, c * H * W, x.device
        data = getattr(block, net).conv_forward_data()
        data = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in data.items()}
        wp = fs.prep_weights(data, mode)
        wm = {m: fs.prep_weights(data, m) for m in extra}
        mid = data["w2"].shape[0]
        betas = [float(v) for v in data["betas"].cpu()]
        idx = torch.arange(B, dtype=torch.int32, device=dev)
        cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
        xf = x.reshape(B, D).contiguous()
        t1k, t1p = (torch.zeros(B, mid, HW, device=dev) for _ in range(2))
        t2k, t2p = (torch.zeros(B, mid, HW, device=dev) for _ in range(2))
        gk, gp = (torch.zeros(B, D, device=dev) for _ in range(2))
        w1, w2, w3 = data["w1"].float(), data["w2"].float(), data["w3"].float()
        b1, b2, b3 = (data[k].float().contiguous() for k in ("b1", "b2", "b3"))
        who = "" if net == "nnet_z" else f", {net}"

        calls = {
            # modes tf32 / tf32x on the tensor cores: W1's bf16 halves
            "conv3x3_in": (
                lambda: fs.conv3x3_in(x, idx, cnt, wp["w1_in"], b1, betas, data["preact"], mode,
                                      t1k),
                lambda: fs._conv3x3_in_plain(x, idx, cnt, wp["w1_in"], b1, betas,
                                             data["preact"], mode, t1p),
                lambda: torch.nn.functional.conv2d(x, w1, b1, padding=1),
                (t1k, t1p),
                4 * (B * D + mid + B * mid * HW) + 4 * w1.numel(),
                B * mid * c * 9 * HW),
            # modes tf32 / tf32x on the tensor cores: W2's bf16 halves
            # (2 bytes an entry each)
            "conv1x1_mid": (
                lambda: fs.conv1x1_mid(t1p, cnt, wp["w2_mid"], b2, betas[2], mode, t2k, H, W),
                lambda: fs._conv1x1_mid_plain(t1p, cnt, wp["w2_mid"], b2, betas[2], mode, t2p,
                                              H, W),
                lambda: torch.nn.functional.conv2d(t1p.view(B, mid, H, W), w2, b2),
                (t2k, t2p),
                4 * (2 * B * mid * HW + mid) + 4 * w2.numel(),
                B * mid * mid * HW),
            # modes tf32 / tf32x on the tensor cores: W3's bf16 halves in
            # the tile layout
            "conv3x3_out": (
                lambda: fs.conv3x3_out(t2p, idx, cnt, wp["w3_tc"], b3, mode, xf, -1.0, xf, gk,
                                       H, W),
                lambda: fs._conv3x3_out_plain(t2p, idx, cnt, wp["w3_tc"], b3, mode, xf, -1.0, xf,
                                              gp, H, W),
                lambda: torch.nn.functional.conv2d(t2p.view(B, mid, H, W), w3, b3, padding=1),
                (gk, gp),
                4 * (B * mid * HW + c + 3 * B * D) + 4 * w3.numel(),
                B * c * mid * 9 * HW),
        }
        for m, wx in wm.items():
            calls[f"conv1x1_mid ({m})"] = (
                lambda m=m, wx=wx: fs.conv1x1_mid(t1p, cnt, wx["w2_mid"], b2, betas[2], m, t2k,
                                                  H, W),
                lambda m=m, wx=wx: fs._conv1x1_mid_plain(t1p, cnt, wx["w2_mid"], b2, betas[2], m,
                                                         t2p, H, W),
                *calls["conv1x1_mid"][2:])
            calls[f"conv3x3_out ({m})"] = (
                lambda m=m, wx=wx: fs.conv3x3_out(t2p, idx, cnt, wx["w3_tc"], b3, m, xf, -1.0, xf,
                                                  gk, H, W),
                lambda m=m, wx=wx: fs._conv3x3_out_plain(t2p, idx, cnt, wx["w3_tc"], b3, m, xf,
                                                         -1.0, xf, gp, H, W),
                *calls["conv3x3_out"][2:])
        for m, wx in wm.items():  # last: they overwrite t1p
            calls[f"conv3x3_in ({m})"] = (
                lambda m=m, wx=wx: fs.conv3x3_in(x, idx, cnt, wx["w1_in"], b1, betas,
                                                 data["preact"], m, t1k),
                lambda m=m, wx=wx: fs._conv3x3_in_plain(x, idx, cnt, wx["w1_in"], b1, betas,
                                                        data["preact"], m, t1p),
                *calls["conv3x3_in"][2:])
        op_max = {}  # each product's largest operand entry, for the scaled probe
        for name, (kern, plain, lib, (out_k, out_p), nbytes, macs) in calls.items():
            m = name[name.index("(") + 1:-1] if name.endswith(")") else mode
            plain()
            kern()
            torch.cuda.synchronize()
            err = rel_err(out_k, out_p)
            # float32 sums in another order over K <= 4608 products
            tol = KERNEL_TOL["f32"] if m == "f32" else SPLIT_TOL
            assert math.isfinite(err) and err <= tol, (phase, name, s, err)
            if name in ("conv1x1_mid", "conv3x3_out"):  # their real operands' range
                op_max[name] = float((t1p if name == "conv1x1_mid" else t2p).abs().max())
            ms, pms, lms = (device_ms(lambda i, f=f: f()) for f in (kern, plain, lib))
            bms, by = bound_ms(nbytes, macs, m)
            log(f"kernel {name} scale{s} ({c}x{H}x{W}, B={B}, {m}{who}): "
                f"max_rel_err {err:.3e} ms {ms:.4f} plain_ms {pms:.4f} "
                f"library_ms {lms:.4f} bound_ms {bms:.4f} ({by}) share {bms / ms:.3f} "
                f"bytes/s {nbytes / ms * 1e3:.4g}")
            rows.setdefault(name, {})[s] = dict(
                max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
                plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)
        op_max["conv3x3_in"] = float(x.abs().max())
        # conv3x3_in on half the slots under a permuted idx, as late solve
        # iterations run it: the dead slots of out untouched
        for m, wq in ((mode, wp), *wm.items()):
            tol = KERNEL_TOL["f32"] if m == "f32" else SPLIT_TOL
            probe_fails += check_partial_list(
                "conv3x3_in",
                lambda i, n, o, m=m, wq=wq: fs.conv3x3_in(x, i, n, wq["w1_in"], b1, betas,
                                                          data["preact"], m, o),
                lambda i, n, o, m=m, wq=wq: fs._conv3x3_in_plain(x, i, n, wq["w1_in"], b1, betas,
                                                                 data["preact"], m, o),
                None, (B, mid, HW), False, m, f"scale{s} ({c}x{H}x{W}, B={B})", dev, tol=tol)
            # conv3x3_out's slots read t2[s] and write example idx[s]: the
            # other examples' rows untouched
            probe_fails += check_partial_list(
                "conv3x3_out",
                lambda i, n, o, wq=wq, m=m: fs.conv3x3_out(t2p, i, n, wq["w3_tc"], b3, m, xf, -1.0,
                                                           xf, o, H, W),
                lambda i, n, o, wq=wq, m=m: fs._conv3x3_out_plain(t2p, i, n, wq["w3_tc"], b3, m,
                                                                  xf, -1.0, xf, o, H, W),
                None, (B, D), True, m, f"scale{s} ({c}x{H}x{W}, B={B})", dev, tol=tol)

        # broyden_step in its three phases on mid-solve states, on the whole
        # list and on half the slots under a permuted list; or on the state
        # captured at this scale
        step_rows, step_fails = (check_broyden_step(s, B, D, dev) if states is None
                                 else check_step_state(s, states[s]))
        for name, by_scale in step_rows.items():
            rows.setdefault(name, {}).update(by_scale)
        probe_fails += step_fails

        # the precision probe through each conv kernel at this scale's shapes
        PB = PROBE_BATCH
        pidx = torch.arange(PB, dtype=torch.int32, device=dev)
        pcnt = torch.full((1,), PB, dtype=torch.int32, device=dev)
        zm, zc, zb = (torch.zeros(*shape, device=dev) for shape in ((mid,), (c,), (PB, D)))

        def conv_in(f):
            def run(m, x, w):
                o = torch.zeros(PB, mid, HW, device=dev)
                f(x, pidx, pcnt, fs.prep_conv1x1_mid(fs.prep_weight(w, m), m), zm, [1.0] * 3,
                  False, m, o)
                return [o]
            return run

        def conv_mid(f):
            def run(m, x, w):
                o = torch.zeros(PB, mid, HW, device=dev)
                f(x, pcnt, fs.prep_conv1x1_mid(fs.prep_weight(w, m), m), zm, 1.0, m, o, H, W)
                return [o]
            return run

        def conv_out(f):
            def run(m, x, w):
                o = torch.zeros(PB, D, device=dev)
                f(x, pidx, pcnt, fs.prep_conv3x3_out(fs.prep_weight(w, m), m), zc, m, zb, 1.0,
                  None, o, H, W)
                return [o]
            return run

        x1, w1p = probe_operands(PB, c, mid, H, W, 3, s, dev)
        t1p, w2p = probe_operands(PB, mid, mid, H, W, 1, s, dev)
        t2p, w3p = probe_operands(PB, mid, c, H, W, 3, s, dev)
        if probe_range:
            acts = {"conv3x3_in": x1, "conv1x1_mid": t1p, "conv3x3_out": t2p}
            # powers of two: every entry scales exactly
            scales = {n: 2.0 ** round(math.log2(op_max[n] / float(v.abs().max())))
                      for n, v in acts.items()}
            log(f"{phase} probe scale{s}: activations scaled to the operands' range "
                f"(max {', '.join(f'{n} {op_max[n]:.3g}' for n in scales)}) by "
                f"{', '.join(f'{n} {v:g}' for n, v in scales.items())}")
            x1, t1p, t2p = (v * scales[n] for n, v in acts.items())
        check_tf32_probe({
            "conv3x3_in": (conv_in(fs.conv3x3_in), conv_in(fs._conv3x3_in_plain), x1, w1p),
            "conv1x1_mid": (conv_mid(fs.conv1x1_mid), conv_mid(fs._conv1x1_mid_plain),
                            t1p.reshape(PB, mid, HW), w2p),
            "conv3x3_out": (conv_out(fs.conv3x3_out), conv_out(fs._conv3x3_out_plain),
                            t2p.reshape(PB, mid, HW), w3p),
        }, f"scale{s} ({c}x{H}x{W}, B={PB})", rel_max if probe_range else rel_err, SPLIT_TOL,
            probe_fails)
    assert not probe_fails, (f"{phase} probe, partial list or broyden_step (name, scale, mode, "
                             "error, controls)", probe_fails)
    return rows


STEP_NSTEPS = (1, 10, 29)  # phase 2's broyden_step states: planes written (K 30)


def broyden_state(B, D, K, nk, seed, dev):
    """A mid-solve Broyden state of B examples: nk secant planes written,
    a secant-like last step (delta_g = -0.5 delta_z keeps <vT, dg> away
    from 0), the best objective above the residual's norm."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    st = {k: rnd(B, D) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG")}
    st["G"] = st["GN"] + 0.5 * st["UPD"]
    st["U"], st["V"] = torch.zeros(B, K, D, device=dev), torch.zeros(B, K, D, device=dev)
    st["U"][:, :nk], st["V"][:, :nk] = 0.01 * rnd(B, nk, D), 0.01 * rnd(B, nk, D)
    st["ist"] = torch.tensor([nk, nk, 0, 0], dtype=torch.int32, device=dev).repeat(B, 1)
    norm = st["GN"].norm(dim=1)
    st["fst"] = torch.stack([norm * 1.5, norm * 2, norm * 3], 1).contiguous()
    return st


def check_broyden_step(s, B, D, dev):
    """Phase 2's broyden_step at one scale's D: the kernel against its plain
    version in PHASE_INIT, PHASE_STEP and PHASE_REARM on states with nstep
    STEP_NSTEPS planes written (K 30), on every slot and on half the slots
    under a permuted list: ist and the next active list equal, every state
    tensor within SPLIT_TOL (max error over the largest entry, at least 1),
    and on the half list the other examples' state bitwise as before. Times
    PHASE_STEP on every slot (device time, plain time, bound: the bytes
    4 B D (2 nstep + 12)). Returns (rows of nstep 10, failures)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    K = 30
    kw = dict(eps=1e-3, cap=K, patience=5, rtol=0.05, guard_eps=3e-3, newton=True)
    gen = torch.Generator(device=dev).manual_seed(100 + s)
    lists = {"every slot": torch.arange(B, dtype=torch.int32, device=dev),
             "half the slots, permuted": torch.randperm(B, generator=gen, device=dev)[
                 :B // 2].to(torch.int32)}
    rows, fails = {}, []
    for nk in STEP_NSTEPS:
        st0 = broyden_state(B, D, K, nk, 10 * s + nk, dev)
        for phase in (fs.PHASE_INIT, fs.PHASE_STEP, fs.PHASE_REARM):
            for which, idx in lists.items():
                cnt = torch.full((1,), len(idx), dtype=torch.int32, device=dev)
                outs = {}
                for tag, fn in (("kernel", fs.broyden_step), ("plain", fs._broyden_step_plain)):
                    st = {k: v.clone() for k, v in st0.items()}
                    io = torch.zeros(B, dtype=torch.int32, device=dev)
                    co = torch.zeros(1, dtype=torch.int32, device=dev)
                    fn(phase, idx, cnt, io, co, st, **kw)
                    torch.cuda.synchronize()
                    outs[tag] = (st, io[:int(co.item())].sort().values)
                (stk, ik), (stp, ip) = outs["kernel"], outs["plain"]
                err = max(rel_err(stk[k].float(), stp[k].float()) for k in stk)
                dead = torch.ones(B, dtype=torch.bool, device=dev)
                dead[idx.long()] = False
                kept = all(torch.equal(stk[k][dead], st0[k][dead]) for k in stk)
                same = torch.equal(ik, ip) and torch.equal(stk["ist"], stp["ist"])
                log(f"broyden_step scale{s} (B={B}, D={D}) phase {phase} nstep {nk} {which}: "
                    f"max_rel_err {err:.3e} (limit {SPLIT_TOL:g}), ist and next list equal "
                    f"{same}, {len(ik)} next active, other examples untouched {kept}")
                if not (math.isfinite(err) and err <= SPLIT_TOL and same and kept):
                    fails.append(("broyden_step", s, phase, nk, which, err, same, kept))
        # PHASE_STEP on every slot, timed: a fresh copy of the state a call
        idx, reps = lists["every slot"], 10
        cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
        io = torch.zeros(B, dtype=torch.int32, device=dev)
        co = torch.zeros(1, dtype=torch.int32, device=dev)
        times = {}
        for tag, fn in (("kernel", fs.broyden_step), ("plain", fs._broyden_step_plain)):
            # a fresh copy a call (the warm-up, and device_ms's repeats), so
            # that every call steps from nstep nk
            copies = iter([{k: v.clone() for k, v in st0.items()} for _ in range(4 * reps + 1)])
            times[tag] = device_ms(lambda i: fn(fs.PHASE_STEP, idx, cnt, io, co, next(copies),
                                                **kw), reps)
            del copies
        nbytes = 4 * B * D * (2 * nk + 12)
        bms, by = bound_ms(nbytes, 0, "f32")
        ms, pms = times["kernel"], times["plain"]
        log(f"kernel broyden_step scale{s} (B={B}, D={D}, nstep {nk}): ms {ms:.4f} plain_ms "
            f"{pms:.4f} bound_ms {bms:.4f} ({by}) share {bms / ms:.3f} bytes/s "
            f"{nbytes / ms * 1e3:.4g}")
        if nk == 10:
            st = {k: v.clone() for k, v in st0.items()}
            stp = {k: v.clone() for k, v in st0.items()}
            fs.broyden_step(fs.PHASE_STEP, idx, cnt, io, co, st, **kw)
            fs._broyden_step_plain(fs.PHASE_STEP, idx, cnt, io, co, stp, **kw)
            torch.cuda.synchronize()
            rows["broyden_step"] = {s: dict(
                max_abs_err=max(float((st[k].float() - stp[k].float()).abs().max())
                                for k in st),
                ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by)}
    return rows, fails


def check_step_state(s, snap):
    """broyden_step on one captured solve state ``snap`` (phase, idx, cnt,
    state and the solve's keywords, :func:`record_step_state`), kernel
    against plain as :func:`check_broyden_step` holds them, and timed.
    Returns (rows, failures)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    phase, idx, cnt, st0, kw = snap
    B, D = st0["Z"].shape
    nk = int(st0["ist"][idx[:int(cnt.item())].long(), 0].float().mean())
    dev = idx.device
    outs = {}
    for tag, fn in (("kernel", fs.broyden_step), ("plain", fs._broyden_step_plain)):
        st = {k: v.clone() for k, v in st0.items()}
        io = torch.zeros(B, dtype=torch.int32, device=dev)
        co = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(phase, idx, cnt, io, co, st, **kw)
        torch.cuda.synchronize()
        outs[tag] = (st, io[:int(co.item())].sort().values)
    (stk, ik), (stp, ip) = outs["kernel"], outs["plain"]
    err = max(rel_err(stk[k].float(), stp[k].float()) for k in stk)
    same = torch.equal(ik, ip) and torch.equal(stk["ist"], stp["ist"])
    times = {}
    for tag, fn in (("kernel", fs.broyden_step), ("plain", fs._broyden_step_plain)):
        copies = iter([{k: v.clone() for k, v in st0.items()} for _ in range(41)])
        io = torch.zeros(B, dtype=torch.int32, device=dev)
        co = torch.zeros(1, dtype=torch.int32, device=dev)
        times[tag] = device_ms(lambda i: fn(phase, idx, cnt, io, co, next(copies), **kw), 10)
        del copies
    live = int(cnt.item())
    nbytes = 4 * live * D * (2 * nk + 12)
    bms, by = bound_ms(nbytes, 0, "f32")
    ms, pms = times["kernel"], times["plain"]
    log(f"broyden_step scale{s} (B={B}, D={D}) captured state, phase {phase}, {live} live, "
        f"mean nstep {nk}: max_rel_err {err:.3e} (limit {SPLIT_TOL:g}), ist and next list equal "
        f"{same}, {len(ik)} next active; ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} "
        f"({by}) share {bms / ms:.3f}")
    rows = {"broyden_step": {s: dict(
        max_abs_err=max(float((stk[k].float() - stp[k].float()).abs().max()) for k in stk),
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by)}}
    ok = math.isfinite(err) and err <= SPLIT_TOL and same
    return rows, [] if ok else [("broyden_step", s, phase, nk, "captured state", err, same)]


def probe_operands(batch, cin, cout, H, W, k, seed, dev):
    """The precision probe's (x, w) (ops/precision_probe.py) on the card."""
    from implicit_normalizing_flows_torch.ops.precision_probe import tf32_probe

    return tuple(torch.from_numpy(a).to(dev)
                 for a in tf32_probe(batch, cin, cout, H, W, k, seed))


def check_tf32_probe(cases, label, measure, tol, fails):
    """Hold each split-mode kernel on the precision probe (phases 2 and 14):
    ``cases`` maps a name to (kernel(mode, x, w), plain(mode, x, w), x, w),
    each call returning its outputs. In tf32 the kernel must lie within
    ``tol`` of its plain version in tf32 and above it against the plain
    version in f32 and native TF32 emulated (plain f32 on both operands
    rounded to 10 mantissa bits); in tf32x within ``tol`` of plain tf32x
    and above it against plain tf32. A reading is the largest over the
    outputs. Prints every reading; appends a failure to ``fails``."""
    from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32

    for name, (kern, plain, x, w) in cases.items():
        ref = {m: plain(m, x, w) for m in ("tf32", "tf32x", "f32")}
        ref["native tf32"] = plain("f32", round_tf32(x), round_tf32(w))
        for mode, controls in (("tf32", ("f32", "native tf32")), ("tf32x", ("tf32",))):
            out = kern(mode, x, w)
            torch.cuda.synchronize()
            read = lambda r: max(measure(a, b) for a, b in zip(out, r))
            err, ctrl = read(ref[mode]), {c: read(ref[c]) for c in controls}
            log(f"probe {name} {label}, {mode}: error {err:.3e} (limit {tol:g}), controls "
                + ", ".join(f"{c} {v:.3e}" for c, v in ctrl.items()))
            if not (math.isfinite(err) and err <= tol and all(v > tol for v in ctrl.values())):
                fails.append((name, label, mode, err, ctrl))


def solve_configs(eps=None):
    """Phase 3's solves (mode, eps, ladder keywords): each mode at eps 1e-6,
    tf32 with the ladder from iteration 15, the split modes at eps 1e-5 and
    tf32 with the ladder from iteration 6 there; those at ``eps`` alone
    when given."""
    ladder = lambda start: dict(tail_mode=("tf32x", "f32"), tail_start=start)
    configs = [("f32", 1e-6, {}), ("tf32", 1e-6, {}), ("tf32x", 1e-6, {}),
               ("tf32", 1e-6, ladder(15)), ("tf32", 1e-5, {}),
               ("tf32x", 1e-5, {}), ("tf32", 1e-5, ladder(6))]
    return [c for c in configs if eps is None or c[1] == eps]


def check_solves(blocks, configs=None, inverse=False, phase="phase 3"):
    """Phase 3: whole solve, kernels vs plain, per scale and mode
    (``configs``, default :func:`solve_configs`); with ``inverse`` the
    inverse's solve of x from the block's input z, net z embedding and net
    x solved.

    Both are solves of the same map whose iterates differ only through
    float sums in another order. At the production tolerance (eps 1e-6,
    about 1e-6 per element) the split modes sit at their own rounding
    floor (about 2^-18 per product), so which iteration first dips under
    the tolerance is noise there: those runs are held to equal converged and
    protective-break flags and close roots. Per-example iteration counts
    must agree within one where the tolerance lies above the floor: in f32,
    and in the split modes at eps 1e-5. Each run also reads its sum-order
    floors: the plain solve with conv1x1_mid, conv3x3_in, both,
    conv3x3_out, all three, or broyden_step summed exactly, or broyden_step
    summed in its cluster kernel's order (ops/sum_order.py), against the
    plain solve, by the same measures (no limit is held to them). Every
    reading is printed before any limit is checked."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import sum_order as so

    kw = dict(threshold=30, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
              newton_init=True, warm_start=True)
    configs = solve_configs() if configs is None else configs
    floor_ops = {"conv1x1_mid exact": dict(fs._PLAIN, conv1x1_mid=so.conv1x1_mid_exact),
                 "conv3x3_in exact": dict(fs._PLAIN, conv3x3_in=so.conv3x3_in_exact),
                 "both exact": dict(fs._PLAIN, conv1x1_mid=so.conv1x1_mid_exact,
                                    conv3x3_in=so.conv3x3_in_exact),
                 "conv3x3_out exact": dict(fs._PLAIN, conv3x3_out=so.conv3x3_out_exact),
                 "all three exact": dict(fs._PLAIN, conv1x1_mid=so.conv1x1_mid_exact,
                                         conv3x3_in=so.conv3x3_in_exact,
                                         conv3x3_out=so.conv3x3_out_exact),
                 "broyden_step exact": dict(fs._PLAIN, broyden_step=so.broyden_step_exact),
                 "broyden_step in its kernel's order": dict(
                     fs._PLAIN, broyden_step=so.broyden_step_tiled)}
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)

    def against(r, ref):
        """(max|dz|, |d nstep| counts, max |d nstep|, examples whose
        converged flag differs, whose protective break differs)."""
        dn = (r.nstep - ref.nstep).abs().long()
        return (float((r.result - ref.result).abs().max()), torch.bincount(dn).tolist(),
                int(dn.max()), int((r.converged != ref.converged).sum()),
                int((r.prot_break != ref.prot_break).sum()))

    fails, what_solve = [], "inverse solve" if inverse else "solve"
    for s, (block, x) in enumerate(blocks):
        dx = block.nnet_x.conv_forward_data()
        dz = block.nnet_z.conv_forward_data()
        if inverse:
            dx, dz = dz, dx
        with torch.no_grad():
            for mode, eps, extra in configs:
                t0 = time.perf_counter()
                rk = fs.fused_broyden_solve(x, dx, dz, mode=mode, eps=eps, **kw, **extra)
                torch.cuda.synchronize()
                tk = time.perf_counter() - t0
                t0 = time.perf_counter()
                rp = fs.fused_broyden_solve_plain(x, dx, dz, mode=mode, eps=eps,
                                                  **kw, **extra)
                torch.cuda.synchronize()
                tp = time.perf_counter() - t0
                floors = []
                for what, ops in floor_ops.items():
                    rx = fs._solve(x, dx, dz, ops, **dict(full, **kw, **extra), mode=mode,
                                   eps=eps)[0]
                    fz, fcounts, _, fconv, fprot = against(rx, rp)
                    floors.append(f"{what} vs plain: max|dz| {fz:.3e} |d nstep| counts "
                                  f"{fcounts} converged flags differing {fconv} prot flags "
                                  f"differing {fprot}")
                    del rx
                dz_max, counts, dn_max, dconv, dprot = against(rk, rp)
                label = f"{mode}{'+ladder' if extra else ''} eps {eps:g}"
                log(f"{what_solve} scale{s} {label}: max|dz| {dz_max:.3e} "
                    f"|d nstep| counts {counts} "
                    f"nstep mean {rk.nstep.float().mean():.2f}/{rp.nstep.float().mean():.2f} "
                    f"converged {rk.converged.float().mean():.3f}/{rp.converged.float().mean():.3f} "
                    f"prot {int(rk.prot_break.sum())}/{int(rp.prot_break.sum())} "
                    f"s {tk:.3f}/{tp:.3f} (kernels/plain); sum-order floors: "
                    + "; ".join(floors))
                if not torch.isfinite(rk.result).all():
                    fails.append((s, label, "non-finite root"))
                if dprot or dconv or not dz_max <= 5e-4:
                    fails.append((s, label, "flags or dz", dprot, dconv, dz_max))
                if (mode == "f32" or eps > 1e-6) and dn_max > 1:
                    fails.append((s, label, "nstep", dn_max))
    assert not fails, (f"{phase} (scale, run, what, readings)", fails)


def profile_batch(model, step, x_u8, draws, solve="solve", label="batch"):
    """Device time by kernel over one main-path batch, ``step(x_u8,
    draws)``, the device's idle share (1 - busy time / wall time,
    :func:`device_busy`), and the host-clock time spent in the blocks'
    solves (their method ``solve``, synchronised around each); returns the
    kernels' profiler records."""
    from torch.profiler import ProfilerActivity, profile

    solve_ms = []

    def timed(fn):
        def run(x):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            solve_ms.append(1e3 * (time.perf_counter() - t))
            return out
        return run

    blocks = model.implicit_blocks()
    for b in blocks:
        setattr(b, solve, timed(getattr(b, solve)))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(x_u8, draws)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        for b in blocks:
            delattr(b, solve)
    log(f"profile {label}: solves {sum(solve_ms):.1f} ms wall "
        f"({', '.join(f'{t:.1f}' for t in solve_ms)} per block), rest "
        f"{wall - sum(solve_ms):.1f} ms")
    events = _kernel_events(prof)
    total, busy, span = device_busy(prof)
    ours = sum(_self_ms(e) for e in events if is_port_kernel(e.key))
    log(f"profile {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms (summed "
        f"{total:.1f}, span {span:.1f}), idle share {1 - busy / wall:.3f}, solve kernels "
        f"{ours:.1f} ms, other device work {total - ours:.1f} ms")
    for e in sorted(events, key=_self_ms, reverse=True)[:15]:
        log(f"  {_self_ms(e):9.2f} ms  x{e.count:<5d} {e.key[:110]}")
    return events


def rel_max(a, b):
    """max|a - b| over max|b| (the relative-to-max error of a whole tensor)."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))


def rel_norm(a, b, base=None):
    """||a - b|| over ||b - base||: the error of a whole function's output
    relative to the part of it that products make (u - grad of a backward
    solve, d_x - u of a re-attachment). An iterate one float32 ulp apart
    rounds to another bfloat16 at a few ties and moves a few entries; a
    skipped rounding moves them all."""
    b = b.double()
    ref = b if base is None else b - base.double()
    return float((a.double() - b).norm() / ref.norm().clamp(min=1e-300))


def capture_grad_inputs(step, x_u8, draws):
    """The implicit gradient's real inputs at each scale's last block, from
    one training step's gradient with every plain version forced
    (plain_versions), so that the inputs, and the floors phase 6 reads on
    them, do not move with the port's kernels: {c: dict(block, grad, z, x,
    z_hat, u, data_x, data_z)} keyed by the scale's channel count."""
    with patched(plain_versions(False)):
        return _capture_grad_inputs(step, x_u8, draws)


def _capture_grad_inputs(step, x_u8, draws):
    from implicit_normalizing_flows_torch.layers import ImplicitBlock, implicit_block

    seen = {}
    orig_bwd, orig_re = ImplicitBlock.backward_solve, implicit_block.fused_reattach_vjp
    det = lambda d: {k: (v.detach().clone() if torch.is_tensor(v) else v) for k, v in d.items()}

    def rec_bwd(self, grad, z):
        seen.setdefault(grad.shape[1], {}).setdefault("bwd", dict(
            block=self, grad=grad.detach().float().clone(), z=z.detach().clone()))
        return orig_bwd(self, grad, z)

    def rec_re(x, z_hat, u, data_x, data_z, mode):
        seen.setdefault(x.shape[1], {}).setdefault("re", dict(
            x=x.detach().clone(), z_hat=z_hat.clone(), u=u.clone(),
            data_x=det(data_x), data_z=det(data_z)))
        return orig_re(x, z_hat, u, data_x, data_z, mode=mode)

    ImplicitBlock.backward_solve = rec_bwd
    implicit_block.fused_reattach_vjp = rec_re
    try:
        step.grads(x_u8, draws)
    finally:
        ImplicitBlock.backward_solve = orig_bwd
        implicit_block.fused_reattach_vjp = orig_re
    return {c: dict(**v["bwd"], **v["re"]) for c, v in sorted(seen.items())}


def nbytes(*ts):
    """Bytes of the tensors, each moved once (None skips). A (tensor,
    itemsize) pair counts the tensor at that itemsize: a float32 tensor
    that holds bfloat16 values needs 2 bytes an entry."""
    pairs = [t if isinstance(t, tuple) else (t, t.element_size()) for t in ts
             if t is not None]
    return sum(t.numel() * size for t, size in pairs)


def check_grad_kernels(cap, modes=("bf16", "f32")):
    """Phase 5: every implicit-gradient kernel vs its plain version at each
    scale's shapes, on the captured inputs, in each mode: error, device
    time, plain time, bound and a cuDNN call's time at the mode's dtype; in
    bf16 also the control (the plain version in mode f32 on the same inputs
    against the bf16 one). Every reading is printed before the limits are
    checked. Returns the bf16 rows (the training default)."""
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops.fused_solve import dswish, prep_weight, swish

    F = torch.nn.functional
    rows, fails = {}, []
    for s, (c, d) in enumerate(cap.items()):
        x, u, G = d["x"], d["u"], d["grad"]
        B, _, H, W = x.shape
        HW, D, dev = H * W, c * H * W, x.device
        idx = torch.arange(B, dtype=torch.int32, device=dev)
        cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
        dx = d["data_x"]
        b0, b1, b2 = (float(v) for v in dx["betas"].cpu())
        bd = dx["betas"].detach().float().contiguous()  # the slopes on the card
        preact = dx["preact"]
        act0 = "swish" if preact else "id"
        mid = dx["w2"].shape[0]
        w1, w2, w3 = (dx[k].float() for k in ("w1", "w2", "w3"))
        bb1, bb2 = dx["b1"].float().contiguous(), dx["b2"].float().contiguous()
        U, Gf = u.reshape(B, D).contiguous(), G.reshape(B, D).contiguous()
        new = lambda *shape: torch.zeros(*shape, device=dev)
        S, _ = ig.wgrad_splits(mid, mid, B, HW)
        for mode in modes:
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            # the linearisation as the backward solve takes it: s0/s1/s2 in
            # the mode's dtype, read as stored
            s0, s1, s2, w1c, w2c, w3c = d["block"].nnet_z.conv_chain_data(d["z"], dtype)
            S0 = s0.reshape(B, D).contiguous()
            S1, S2 = (t.reshape(B, mid, HW).contiguous() for t in (s1, s2))
            src = (ig.transpose_weights(w1c.float(), w2c.float(), w3c.float())
                   + (w1, w2) + ig.transpose_weights(w1, w2, w3))
            # (jt3, jt2, jt1, f1, f2, t3, t2, t1) prepared for mode m, jt3 and
            # jt2 as the backward solve prepares them and f1, f2, t3, t2 as the
            # re-attachment does (bfloat16 in mode bf16)
            prep = lambda m: [ig.prep_mid_weight(w, m) if i in (0, 1)
                              else ig.prep_rv_mid_weight(w, m) if i in (3, 4, 5, 6)
                              else prep_weight(w, m) for i, w in enumerate(src)]
            jt3, jt2, jt1, f1, f2, t3, t2, t1 = prep(mode)
            # plain outputs first: each later kernel takes the plain result
            # of the one before as its input
            P = {k: new(B, mid, HW) for k in ("T2", "T1", "H1", "H2", "C2", "C1")}
            P.update(R=new(B, D), C0=new(B, D), part=new(S, mid, mid),
                     dW2=new(mid, mid), sums=new(mid), db=new(mid),
                     db_k=new(mid), db_p=new(mid), s0_k=new(c), s0_p=new(c),
                     db0_k=new(c), db0_p=new(c))
            ig._jt_conv3x3_in_plain(u, idx, cnt, jt3, S2, mode, P["T2"])
            ig._jt_conv1x1_mid_plain(P["T2"], idx, cnt, jt2, S1, mode, P["T1"], H, W)
            ig._jt_conv3x3_out_plain(P["T1"], idx, cnt, jt1, S0, mode, U, Gf, P["R"], H, W)
            ig._rv_conv3x3_in_plain(x, idx, cnt, f1, bb1, 1.0, bd[0:1], act0, mode, P["H1"])
            ig._rv_conv1x1_mid_plain(P["H1"], P["H1"], cnt, f2, bb2, 1.0, b1, "swish",
                                     mode, P["H2"], H, W)
            ig._rv_conv3x3_in_plain(u, idx, cnt, t3, None, 1.0, None, "id", mode, P["C2"])
            ig._rv_conv1x1_mid_plain(P["C2"], P["H2"], cnt, t2, None, 1.0, b2, "dswish",
                                     mode, P["C1"], H, W)
            ig._rv_conv3x3_out_plain(P["C1"], P["H1"], b1, idx, cnt, t1, mode, P["C0"], H, W)
            wg = (P["C2"], P["H2"], bd[2], P["H1"], None, bd[1], "swish", False)
            ig._rv_wgrad_plain(*wg, mode, P["part"], H, W)
            # every weight gradient the re-attachment launches: dW3 (u x
            # shift(swish(h2))), dW1 with preact (t1 swish'(h1) x
            # shift(swish(x))) and without (x as it is)
            U3 = u.reshape(B, c, HW)
            # rv_chan_sums' M = c form on net x's t0 (its plain C1^T product)
            # and x under preact
            T0 = P["C0"].view(B, c, HW)
            H0 = x.reshape(B, c, HW) if act0 == "swish" else None
            wg3 = (U3, None, None, P["H2"], None, bd[2], "swish", True)
            wg1 = (P["C1"], P["H1"], bd[1], x, None, bd[0], "swish", True)
            wg1n = (P["C1"], P["H1"], bd[1], x, None, None, "id", True)
            S3, _ = ig.wgrad_splits(c, mid * 9, B, HW)
            S1_, _ = ig.wgrad_splits(mid, c * 9, B, HW)
            ig._rv_wgrad_reduce_plain(P["part"], 1.0, P["dW2"])
            ig._rv_chan_sums_plain(P["C2"], P["H2"], b2, 1.0, None, P["sums"], P["db"], None)
            lib = lambda t: t.to(dtype)  # the library call at the mode's dtype

            def cases(m, wt):
                """name: (kernel, plain, library call, output shape, the
                other tensors moved (weights once: f32 and bf16 read no lo
                split), MACs), at mode m with weights wt."""
                jt3, jt2, jt1, f1, f2, t3, t2, t1 = wt
                return {
                    "jt_conv3x3_in": (
                        lambda o: ig.jt_conv3x3_in(u, idx, cnt, jt3, S2, m, o),
                        lambda o: ig._jt_conv3x3_in_plain(u, idx, cnt, jt3, S2, m, o),
                        lambda: F.conv_transpose2d(lib(u), lib(w3c), padding=1),
                        (B, mid, HW), (u, S2, jt3[0]), B * mid * c * 9 * HW),
                    "jt_conv1x1_mid": (
                        lambda o: ig.jt_conv1x1_mid(P["T2"], idx, cnt, jt2, S1, m, o, H, W),
                        lambda o: ig._jt_conv1x1_mid_plain(P["T2"], idx, cnt, jt2, S1, m, o, H, W),
                        lambda: F.conv_transpose2d(lib(P["T2"]).view(B, mid, H, W), lib(w2c)),
                        (B, mid, HW), (P["T2"], S1, jt2[0]), B * mid * mid * HW),
                    "jt_conv3x3_out": (
                        lambda o: ig.jt_conv3x3_out(P["T1"], idx, cnt, jt1, S0, m, U, Gf, o, H, W),
                        lambda o: ig._jt_conv3x3_out_plain(P["T1"], idx, cnt, jt1, S0, m, U, Gf, o, H, W),
                        lambda: F.conv_transpose2d(lib(P["T1"]).view(B, mid, H, W), lib(w1c), padding=1),
                        (B, D), (P["T1"], jt1[0], S0, U, Gf), B * c * mid * 9 * HW),
                    "rv_conv3x3_in": (
                        lambda o: ig.rv_conv3x3_in(x, idx, cnt, f1, bb1, 1.0, bd[0:1], act0, m, o),
                        lambda o: ig._rv_conv3x3_in_plain(x, idx, cnt, f1, bb1, 1.0, bd[0:1], act0, m, o),
                        lambda: F.conv2d(lib(x), lib(w1), lib(bb1), padding=1),
                        (B, mid, HW), (x, f1[0], bb1), B * mid * c * 9 * HW),
                    # net z's raw cotangent t2 = -C3^T u
                    "rv_conv3x3_in (t2, alpha -1)": (
                        lambda o: ig.rv_conv3x3_in(u, idx, cnt, t3, None, -1.0, None, "id", m, o),
                        lambda o: ig._rv_conv3x3_in_plain(u, idx, cnt, t3, None, -1.0, None, "id", m, o),
                        lambda: F.conv_transpose2d(lib(u), lib(w3), padding=1),
                        (B, mid, HW), (u, t3[0]), B * mid * c * 9 * HW),
                    "rv_conv1x1_mid": (
                        lambda o: ig.rv_conv1x1_mid(P["H1"], P["H1"], cnt, f2, bb2, 1.0, bd[1:2], "swish", m, o, H, W),
                        lambda o: ig._rv_conv1x1_mid_plain(P["H1"], P["H1"], cnt, f2, bb2, 1.0, bd[1:2], "swish", m, o, H, W),
                        lambda: F.conv2d(lib(swish(P["H1"], b1)).view(B, mid, H, W), lib(w2), lib(bb2)),
                        (B, mid, HW), (P["H1"], f2[0], bb2), B * mid * mid * HW),
                    "rv_conv1x1_mid (dswish)": (
                        lambda o: ig.rv_conv1x1_mid(P["C2"], P["H2"], cnt, t2, None, 1.0, bd[2:3], "dswish", m, o, H, W),
                        lambda o: ig._rv_conv1x1_mid_plain(P["C2"], P["H2"], cnt, t2, None, 1.0, bd[2:3], "dswish", m, o, H, W),
                        lambda: F.conv_transpose2d(lib(P["C2"] * dswish(P["H2"], b2)).view(B, mid, H, W), lib(w2)),
                        (B, mid, HW), (P["C2"], P["H2"], t2[0]), B * mid * mid * HW),
                    "rv_conv3x3_out": (
                        lambda o: ig.rv_conv3x3_out(P["C1"], P["H1"], b1, idx, cnt, t1, m, o, H, W),
                        lambda o: ig._rv_conv3x3_out_plain(P["C1"], P["H1"], b1, idx, cnt, t1, m, o, H, W),
                        lambda: F.conv_transpose2d(lib(P["C1"]).view(B, mid, H, W), lib(w1), padding=1),
                        (B, D), (P["C1"], P["H1"], t1[0]), B * c * mid * 9 * HW),
                    "rv_wgrad": (
                        lambda o: ig.rv_wgrad(*wg, m, o, H, W),
                        lambda o: ig._rv_wgrad_plain(*wg, m, o, H, W),
                        lambda: torch.nn.grad.conv2d_weight(
                            lib(P["H1"]).view(B, mid, H, W), (mid, mid, 1, 1),
                            lib(P["C2"]).view(B, mid, H, W)),
                        (S, mid, mid), (P["C2"], P["H2"], P["H1"]), mid * mid * B * HW),
                    "rv_wgrad (dW3)": (
                        lambda o: ig.rv_wgrad(*wg3, m, o, H, W),
                        lambda o: ig._rv_wgrad_plain(*wg3, m, o, H, W),
                        lambda: torch.nn.grad.conv2d_weight(
                            lib(swish(P["H2"], b2)).view(B, mid, H, W), (c, mid, 3, 3),
                            lib(u), padding=1),
                        (S3, c, mid * 9), (U3, P["H2"]), c * mid * 9 * B * HW),
                    "rv_wgrad (dW1)": (
                        lambda o: ig.rv_wgrad(*wg1, m, o, H, W),
                        lambda o: ig._rv_wgrad_plain(*wg1, m, o, H, W),
                        lambda: torch.nn.grad.conv2d_weight(
                            lib(swish(x, b0)), (mid, c, 3, 3),
                            lib(P["C1"] * dswish(P["H1"], b1)).view(B, mid, H, W), padding=1),
                        (S1_, mid, c * 9), (P["C1"], P["H1"], x), mid * c * 9 * B * HW),
                    "rv_wgrad (dW1, no preact)": (
                        lambda o: ig.rv_wgrad(*wg1n, m, o, H, W),
                        lambda o: ig._rv_wgrad_plain(*wg1n, m, o, H, W),
                        lambda: torch.nn.grad.conv2d_weight(
                            lib(x), (mid, c, 3, 3),
                            lib(P["C1"] * dswish(P["H1"], b1)).view(B, mid, H, W), padding=1),
                        (S1_, mid, c * 9), (P["C1"], P["H1"], x), mid * c * 9 * B * HW),
                    "rv_wgrad_reduce": (
                        lambda o: ig.rv_wgrad_reduce(P["part"], 1.0, o),
                        lambda o: ig._rv_wgrad_reduce_plain(P["part"], 1.0, o),
                        lambda: P["part"].sum(0),
                        (mid, mid), (P["part"],), S * mid * mid / 2),
                    "rv_chan_sums": (
                        lambda o: ig.rv_chan_sums(P["C2"], P["H2"], b2, 1.0, None, o, P["db_k"], None),
                        lambda o: ig._rv_chan_sums_plain(P["C2"], P["H2"], b2, 1.0, None, o, P["db_p"], None),
                        None, (mid,), (P["C2"], P["H2"], P["db_k"]), 0),
                    # its M = c launches: b3's sums of u (no h), and net x's
                    # t0 = C1^T(...) with d_x = u + t0 swish'(x) (h under
                    # preact: the slope's sums too)
                    "rv_chan_sums (b3)": (
                        lambda o: ig.rv_chan_sums(U3, None, 0.0, -1.0, None, o, None, None),
                        lambda o: ig._rv_chan_sums_plain(U3, None, 0.0, -1.0, None, o, None, None),
                        lambda: U3.sum(dim=(0, 2)), (c,), (U3,), 0),
                    "rv_chan_sums (T0)": (
                        lambda o: ig.rv_chan_sums(T0, H0, bd[0], 1.0, U3, P["s0_k"],
                                                  P["db0_k"] if H0 is not None else None, o),
                        lambda o: ig._rv_chan_sums_plain(T0, H0, bd[0], 1.0, U3, P["s0_p"],
                                                         P["db0_p"] if H0 is not None else None,
                                                         o),
                        None, (B, c, HW), (T0, U3, P["s0_k"]) + (
                            () if H0 is None else (H0, P["db0_k"])), 0),
                }

            ctrl = cases("f32", prep("f32")) if mode != "f32" else {}
            tol = KERNEL_TOL[mode]
            for name, (kern, plain, libc, shape, moved, macs) in cases(mode, (
                    jt3, jt2, jt1, f1, f2, t3, t2, t1)).items():
                ok_, op = new(*shape), new(*shape)
                kern(ok_)
                plain(op)
                torch.cuda.synchronize()
                # relative to the largest entry: the cotangents are small
                # (about 1e-5), so an error relative to max(1, |plain|)
                # would be no check
                err = rel_max(ok_, op)
                if name == "rv_chan_sums":
                    err = max(err, rel_max(P["db_k"], P["db_p"]))
                if name == "rv_chan_sums (T0)":
                    err = max([err, rel_max(P["s0_k"], P["s0_p"])]
                              + ([rel_max(P["db0_k"], P["db0_p"])] if H0 is not None else []))
                control = None
                if name in ctrl and name not in NO_ROUNDING:
                    oc = new(*shape)
                    ctrl[name][1](oc)
                    control = rel_max(oc, op)
                ms = device_ms(lambda i: kern(ok_))
                pms = device_ms(lambda i: plain(op))
                lms = device_ms(lambda i: libc()) if libc is not None else None
                nb = nbytes(*moved) + 4 * math.prod(shape)
                bms, by = bound_ms(nb, macs, mode)
                log(f"kernel {name} scale{s} ({c}x{H}x{W}, B={B}, {mode}): max_rel_err "
                    f"{err:.3e} (limit {tol:g}"
                    + ("" if control is None else f", control {control:.3e}")
                    + f") ms {ms:.4f} plain_ms {pms:.4f} library_ms "
                    f"{'null' if lms is None else f'{lms:.4f}'} bound_ms {bms:.4f} ({by}) "
                    f"share {bms / ms:.3f} bytes/s {nb / ms * 1e3:.4g}")
                if not (math.isfinite(err) and err <= tol
                        and (control is None or control > tol)):
                    fails.append((name, s, mode, err, control))
                if mode == "bf16":
                    rows.setdefault(name, {})[s] = dict(
                        max_abs_err=float((ok_ - op).abs().max()), ms=ms, plain_ms=pms,
                        library_ms=lms, bound_ms=bms, bound_by=by)
            # the tensor-core kernels that take an active list, on half the
            # slots under a permuted idx (rv_conv1x1_mid: a count, no idx)
            ctrl_w = prep("f32")
            label = f"scale{s} ({c}x{H}x{W}, B={B})"
            ri = lambda wp, m: lambda i, n, o: ig.rv_conv3x3_in(x, i, n, wp, bb1, 1.0, bd[0:1],
                                                                act0, m, o)
            rip = lambda wp, m: lambda i, n, o: ig._rv_conv3x3_in_plain(x, i, n, wp, bb1, 1.0,
                                                                        bd[0:1], act0, m, o)
            fails += check_partial_list(
                "rv_conv3x3_in", ri(f1, mode), rip(f1, mode),
                rip(ctrl_w[3], "f32") if mode != "f32" else None, (B, mid, HW), False, mode,
                label, dev)
            rm = lambda wp, m: lambda i, n, o: ig.rv_conv1x1_mid(P["H1"], P["H1"], n, wp, bb2, 1.0,
                                                                 bd[1:2], "swish", m, o, H, W)
            rmp = lambda wp, m: lambda i, n, o: ig._rv_conv1x1_mid_plain(
                P["H1"], P["H1"], n, wp, bb2, 1.0, bd[1:2], "swish", m, o, H, W)
            fails += check_partial_list(
                "rv_conv1x1_mid", rm(f2, mode), rmp(f2, mode),
                rmp(ctrl_w[4], "f32") if mode != "f32" else None, (B, mid, HW), False, mode,
                label, dev)
            ji = lambda wp, m: lambda i, n, o: ig.jt_conv3x3_in(u, i, n, wp, S2, m, o)
            jip = lambda wp, m: lambda i, n, o: ig._jt_conv3x3_in_plain(u, i, n, wp, S2, m, o)
            fails += check_partial_list(
                "jt_conv3x3_in", ji(jt3, mode), jip(jt3, mode),
                jip(ctrl_w[0], "f32") if mode != "f32" else None, (B, mid, HW), False, mode,
                label, dev)
            jt = lambda wp, m: lambda i, n, o: ig.jt_conv1x1_mid(P["T2"], i, n, wp, S1, m, o, H, W)
            jtp = lambda wp, m: lambda i, n, o: ig._jt_conv1x1_mid_plain(P["T2"], i, n, wp, S1,
                                                                         m, o, H, W)
            fails += check_partial_list(
                "jt_conv1x1_mid", jt(jt2, mode), jtp(jt2, mode),
                jtp(ctrl_w[1], "f32") if mode != "f32" else None, (B, mid, HW), False, mode,
                label, dev)
            rv = lambda wp, m: lambda i, n, o: ig.rv_conv3x3_out(P["C1"], P["H1"], b1, i, n, wp,
                                                                 m, o, H, W)
            rvp = lambda wp, m: lambda i, n, o: ig._rv_conv3x3_out_plain(P["C1"], P["H1"], b1, i,
                                                                         n, wp, m, o, H, W)
            fails += check_partial_list(
                "rv_conv3x3_out", rv(t1, mode), rvp(t1, mode),
                rvp(ctrl_w[7], "f32") if mode != "f32" else None, (B, D), True, mode, label,
                dev)
            jo = lambda wp, m: lambda i, n, o: ig.jt_conv3x3_out(P["T1"], i, n, wp, S0, m, U, Gf,
                                                                 o, H, W)
            jop = lambda wp, m: lambda i, n, o: ig._jt_conv3x3_out_plain(P["T1"], i, n, wp, S0,
                                                                         m, U, Gf, o, H, W)
            fails += check_partial_list(
                "jt_conv3x3_out", jo(jt1, mode), jop(jt1, mode),
                jop(ctrl_w[2], "f32") if mode != "f32" else None, (B, D), True, mode, label,
                dev)
    fails += check_chan_sums_shapes(dev)
    assert not fails, ("phase 5 (name, scale, mode, error, control)", fails)
    return rows


def check_chan_sums_shapes(dev, batch=4):
    """rv_chan_sums' kernel off the flagship's float4 path, against its
    plain version on seeded random inputs, in its three forms (b3: no h,
    alpha -1; M = mid: h and dbeta; T0: h, dbeta, base and out, out started
    as NaN so that an element left unwritten fails): HW 49 (MNIST's 7x7,
    single floats) at M 48 and 512, and HW 64 on tensors one float past a
    16-byte boundary. Each output's max error over its largest entry, at
    the sums' phase-5 limit; returns the failures."""
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    g = torch.Generator(device=dev).manual_seed(17)
    tol = KERNEL_TOL["bf16"]
    fails = []
    for M, HW, skew in ((48, 49, 0), (512, 49, 0), (48, 64, 1)):
        shape = (batch, M, HW)
        n = math.prod(shape)
        t, h, base = (torch.randn(n + skew, device=dev, generator=g)[skew:].view(shape)
                      for _ in range(3))
        for form, args in (("b3", (None, 0.0, -1.0, None)), ("mid", (h, 1.1, 1.0, None)),
                           ("T0", (h, 0.9, 1.0, base))):
            has_h, has_out = args[0] is not None, form == "T0"
            outs = {}
            for which, fn in (("kernel", ig.rv_chan_sums), ("plain", ig._rv_chan_sums_plain)):
                sums, db = torch.full((M,), math.nan, device=dev), None
                if has_h:
                    db = torch.full((M,), math.nan, device=dev)
                out = None
                if has_out:
                    out = torch.full((n + skew,), math.nan, device=dev)[skew:].view(shape)
                fn(t, *args, sums, db, out)
                outs[which] = [v for v in (sums, db, out) if v is not None]
            torch.cuda.synchronize()
            err = max(rel_max(a, b) for a, b in zip(outs["kernel"], outs["plain"]))
            plan = ig.chan_sums_plan(M, batch, HW, ig._chan_sums_vec(t, h, base, out))
            log(f"kernel rv_chan_sums ({form}) B={batch} M={M} HW={HW}"
                f"{' one float off 16-byte alignment' if skew else ''} (cluster "
                f"{plan.cluster}, vec {plan.vec}): max_rel_err {err:.3e} (limit {tol:g})")
            if not (math.isfinite(err) and err <= tol):
                fails.append((f"rv_chan_sums ({form})", f"M {M} HW {HW} skew {skew}", err))
    return fails


def check_partial_list(name, kern, plain, ctrl, shape, by_example, mode, label, dev,
                       tol=None):
    """A kernel on half the slots live (count B/2) under a permuted idx, as
    late solve iterations run one: the live rows against the plain version
    (and in bf16 the control ``ctrl``, the plain version in mode f32), and
    the dead rows of out bitwise as they were (a sentinel), at ``tol``
    (KERNEL_TOL of the mode by default). Rows are slots, or the examples
    idx[slot] with ``by_example``. kern, plain and ctrl are fn(idx, count,
    out) on outputs of ``shape``. Returns the failures."""
    B, n = shape[0], shape[0] // 2
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randperm(B, generator=g, device=dev).to(torch.int32)
    cnt = torch.full((1,), n, dtype=torch.int32, device=dev)
    rows = idx.long() if by_example else torch.arange(B, device=dev)
    live, dead_rows = rows[:n], rows[n:]
    sentinel = lambda: torch.full(shape, -7.25, device=dev)
    ok_, op, oc = sentinel(), sentinel(), sentinel()
    kern(idx, cnt, ok_)
    plain(idx, cnt, op)
    torch.cuda.synchronize()
    err = rel_max(ok_[live], op[live])
    dead = torch.equal(ok_[dead_rows].view(torch.int32), sentinel()[dead_rows].view(torch.int32))
    control = None
    if ctrl is not None:
        ctrl(idx, cnt, oc)
        control = rel_max(oc[live], op[live])
    tol = KERNEL_TOL[mode] if tol is None else tol
    log(f"kernel {name} {label}, {mode}, count {n} of {B}, permuted idx: max_rel_err "
        f"{err:.3e} (limit {tol:g}" + ("" if control is None else f", control {control:.3e}")
        + f"), dead {'examples' if by_example else 'slots'} untouched: {dead}")
    ok = math.isfinite(err) and err <= tol and (control is None or control > tol) and dead
    return [] if ok else [(f"{name} partial list", label, mode, err, control, dead)]


def check_grad_functions(cap):
    """Phase 6: the whole backward solve (modes bf16, f32) and
    re-attachment VJP (bf16, f32, tf32) vs their plain versions, per scale.
    f32 at the CPU tests' tolerances (backward solve rtol 1e-4 / atol 1e-5,
    re-attachment rtol 5e-4 / atol 1e-5); bf16 and tf32 by rel_norm at
    BWD_TOL / REATTACH_TOL, beside the control (the plain version in mode
    f32 against the mode's), which in bf16 must lie above the limit for
    every tensor that a product reaches. Every reading is printed before the
    limits are checked. In bf16 and tf32 each function also prints its
    sum-order floors: the plain path with one product summed exactly
    (ops/sum_order.py; in the backward solve jt_conv3x3_in, jt_conv1x1_mid,
    jt_conv3x3_out, the last two together, and all three; in the
    re-attachment rv_wgrad, rv_conv3x3_out, rv_conv1x1_mid, rv_conv3x3_in
    and rv_chan_sums, and rv_chan_sums in its cluster kernel's order)
    against the plain path. No limit is held to them."""
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops import sum_order as so

    kw = dict(threshold=4, eps=1e-10, stall_patience=5, stall_rtol=0.05,
              stall_guard=3.0, newton_init=True)
    # the last conv's bias gradient is the sum of the cotangent: no product
    unrounded = ("x.b3", "z.b3")
    fails = []
    for s, (c, d) in enumerate(cap.items()):
        grad = d["grad"]
        for mode in ig.BWD_MODES:
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            cd = d["block"].nnet_z.conv_chain_data(d["z"], dtype)
            t0 = time.perf_counter()
            rk = ig.fused_backward_solve(grad, cd, mode=mode, **kw)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t0
            t0 = time.perf_counter()
            rp = ig.fused_backward_solve_plain(grad, cd, mode=mode, **kw)
            torch.cuda.synchronize()
            tp = time.perf_counter() - t0
            err = rel_norm(rk.u, rp.u, grad)
            control, floors = None, []
            if mode != "f32":
                control = rel_norm(ig.fused_backward_solve_plain(
                    grad, cd, mode="f32", **kw).u, rp.u, grad)
                exact3 = dict(jt_conv3x3_in=so.jt_conv3x3_in_exact,
                              jt_conv1x1_mid=so.jt_conv1x1_mid_exact,
                              jt_conv3x3_out=so.jt_conv3x3_out_exact)
                for what, exact in (
                        ("jt_conv3x3_in", dict(jt_conv3x3_in=so.jt_conv3x3_in_exact)),
                        ("jt_conv1x1_mid", dict(jt_conv1x1_mid=so.jt_conv1x1_mid_exact)),
                        ("jt_conv3x3_out", dict(jt_conv3x3_out=so.jt_conv3x3_out_exact)),
                        ("jt_conv1x1_mid and jt_conv3x3_out",
                         dict(jt_conv1x1_mid=so.jt_conv1x1_mid_exact,
                              jt_conv3x3_out=so.jt_conv3x3_out_exact)),
                        ("all three", exact3)):
                    ue = ig._backward_solve(grad, cd, dict(ig._PLAIN, **exact), mode=mode,
                                            **kw).u
                    floors.append(f"{rel_norm(ue, rp.u, grad):.3e} ({what} exact)")
            log(f"backward solve scale{s} {mode}: rel_norm {err:.3e}"
                + ("" if control is None else f" (limit {BWD_TOL[mode]:g}, control {control:.3e}, "
                   f"sum-order floors {', '.join(floors)})")
                + f" max|du|/max|u| {rel_max(rk.u, rp.u):.3e}"
                f" nstep {rk.nstep.float().mean():.2f}/{rp.nstep.float().mean():.2f} prot "
                f"{int(rk.prot_break.sum())}/{int(rp.prot_break.sum())} "
                f"s {tk:.3f}/{tp:.3f} (kernels/plain)")
            if not (bool(torch.isfinite(rk.u).all()) and torch.equal(rk.nstep, rp.nstep)
                    and torch.equal(rk.prot_break, rp.prot_break)):
                fails.append(("backward solve", s, mode, "non-finite u, nstep or prot differ"))
            if mode == "f32":
                if not torch.allclose(rk.u, rp.u, rtol=1e-4, atol=1e-5):
                    fails.append(("backward solve", s, mode, "not within rtol 1e-4 / atol 1e-5",
                                  rel_max(rk.u, rp.u)))
            elif not err <= BWD_TOL[mode] < control:
                fails.append(("backward solve", s, mode, err, control))

        u = d["u"]
        args = (d["x"], d["z_hat"], u, d["data_x"], d["data_z"])
        flat = lambda g: [("d_x", g[0])] + [
            (f"{n}.{k}", h[k]) for n, h in (("x", g[1]), ("z", g[2])) for k in ig.DATA_KEYS]
        base = lambda n: u if n == "d_x" else None  # d_x = u + J^T u
        for mode in ig.REATTACH_MODES:
            t0 = time.perf_counter()
            gk = ig.fused_reattach_vjp(*args, mode=mode)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t0
            t0 = time.perf_counter()
            gp = ig.fused_reattach_vjp_plain(*args, mode=mode)
            torch.cuda.synchronize()
            tp = time.perf_counter() - t0
            pairs = [(n, a, b) for (n, a), (_, b) in zip(flat(gk), flat(gp))]
            worst = max((rel_norm(a, b, base(n)), n) for n, a, b in pairs)
            line = f"reattach vjp scale{s} {mode}: worst rel_norm {worst[0]:.3e} ({worst[1]})"
            ctrl = None
            if mode != "f32":
                gc = flat(ig.fused_reattach_vjp_plain(*args, mode="f32"))
                ctrl = min((rel_norm(a, b, base(n)), n)
                           for (n, a), (_, b) in zip(gc, flat(gp)) if n not in unrounded)
                line += f" (limit {REATTACH_TOL[mode]:g}, least control {ctrl[0]:.3e} ({ctrl[1]})"
                for k, fn, how in (("rv_wgrad", so.rv_wgrad_exact, "exact"),
                                   ("rv_conv3x3_out", so.rv_conv3x3_out_exact, "exact"),
                                   ("rv_conv1x1_mid", so.rv_conv1x1_mid_exact, "exact"),
                                   ("rv_conv3x3_in", so.rv_conv3x3_in_exact, "exact"),
                                   ("rv_chan_sums", so.rv_chan_sums_exact, "exact"),
                                   ("rv_chan_sums", so.rv_chan_sums_tiled, "in its kernel's order")):
                    ge = flat(ig._reattach_vjp(*args, dict(ig._PLAIN, **{k: fn}), mode))
                    floor = max((rel_norm(a, b, base(n)), n)
                                for (n, a), (_, b) in zip(ge, flat(gp)))
                    line += f", sum-order floor {floor[0]:.3e} ({floor[1]}; {k} {how})"
                line += ")"
            log(line + f" s {tk:.3f}/{tp:.3f} (kernels/plain)")
            for n, a, b in pairs:
                if not bool(torch.isfinite(a).all()):
                    fails.append(("reattach vjp", s, mode, n, "non-finite"))
                if mode == "f32" and not torch.allclose(a, b, rtol=5e-4, atol=1e-5):
                    fails.append(("reattach vjp", s, mode, n, "not within rtol 5e-4 / atol 1e-5",
                                  rel_max(a, b)))
            if mode != "f32" and not (worst[0] <= REATTACH_TOL[mode]
                                      and (mode != "bf16" or ctrl[0] > REATTACH_TOL[mode])):
                fails.append(("reattach vjp", s, mode, worst, ctrl))
    assert not fails, ("phase 6 (function, scale, mode, error, control)", fails)


def check_bf16_double_backward(dev):
    """The bf16 Neumann estimator differentiates a VJP of the nets: on the
    card it runs bfloat16 convs natively (ops/power_iter.py:conv_apply). Its
    weight gradient of <J^T a, e> must agree with float32's (torch's CPU
    bfloat16 conv gets it wrong, so the CPU computes in float32)."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(*s, device=dev, generator=g)
    x, w0, a, e = r(8, 48, 16, 16), r(512, 48, 3, 3) * 0.05, r(8, 512, 16, 16), r(8, 48, 16, 16)

    def grad_w(dt):
        w = w0.clone().requires_grad_(True)
        xd = x.to(dt).requires_grad_(True)
        y = F.conv2d(xd, w.to(dt), padding=1)
        gx = torch.autograd.grad(y, xd, a.to(dt), create_graph=True)[0]
        return torch.autograd.grad(torch.sum(gx.float() * e), w)[0]

    ref, got = grad_w(torch.float32), grad_w(torch.bfloat16)
    cos = float((ref * got).sum() / (ref.norm() * got.norm()))
    log(f"bf16 conv double backward on the card: cosine with float32 {cos:.6f}")
    assert cos >= 0.999, cos


def capture_estimator_inputs(step, x_u8, draws):
    """The --mem-eff False estimator's real inputs from one training step's
    gradient with every plain version forced (plain_versions: the forward
    solves that make the chains' s factors and probes, the chains that make
    the final pair's accs), so that the inputs, and the floors phase 9 reads
    on them, do not move with the port's kernels; per (channel count,
    preact) of the blocks, the last block of each: the chains' operands,
    signed coefficients and n_power, the final pair's data dicts, (x, z,
    eps_x, eps_z, acc_x, acc_z) and mode, and the backward's acc times the
    cotangent (x's then z's rows)."""
    with patched(plain_versions(True)):
        return _capture_estimator_inputs(step, x_u8, draws)


def _capture_estimator_inputs(step, x_u8, draws):
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff

    seen, pending = {}, {}
    det = lambda v: v.detach().clone() if torch.is_tensor(v) else v
    chain, pair, bwd = fc.fused_neumann_chain2, implicit_block.fused_final_pair, ff._backward

    def rec_chain(chain_x, chain_z, signed, n_power):
        pending.update(chains=[tuple(det(a) for a in ch) for ch in (chain_x, chain_z)],
                       signed=det(signed), n_power=int(n_power))
        return chain(chain_x, chain_z, signed, n_power)

    def rec_pair(data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, *, mode):
        seen[(x.shape[1], bool(data_x["preact"]))] = dict(
            pending, mode=mode, datas=[{k: det(v) for k, v in d.items()} for d in (data_x, data_z)],
            args=[det(a) for a in (x, z, eps_x, eps_z, acc_x, acc_z)])
        return pair(data_x, data_z, x, z, eps_x, eps_z, acc_x, acc_z, mode=mode)

    def rec_bwd(ops, mode, wt, Hs, E, ACCW, preact, datas):
        seen[(Hs.shape[1], preact)].setdefault("accw", ACCW.clone())
        return bwd(ops, mode, wt, Hs, E, ACCW, preact, datas)

    with patched([(fc, "fused_neumann_chain2", rec_chain),
                  (implicit_block, "fused_final_pair", rec_pair), (ff, "_backward", rec_bwd)]):
        step.grads(x_u8, draws)
    return dict(sorted(seen.items(), key=lambda kv: (kv[0][0], not kv[0][1])))


def pair_inputs(d):
    """A captured block's stacked final-pair inputs: (x | z), the probes,
    the accs and the folded cotangent accs."""
    cat = lambda i: torch.cat([d["args"][i], d["args"][i + 1]]).float().contiguous()
    return cat(0), cat(2), cat(4), d["accw"]


def estimator_operands(d, mode):
    """A captured block's stacked operands at ``mode``: the chain's (its
    data cast to the mode's dtype), the final pair's weights and
    :func:`pair_inputs`."""
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff

    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    op = fc.chain_operands([tuple(a.to(dt) for a in ch) for ch in d["chains"]], d["signed"])
    return (op, ff._weights(d["datas"], mode, torch.float32)) + pair_inputs(d)


def check_cases(cases, ctrl, mode, label, rows, fails, *, timed, rounded=(), keep=False):
    """Read each case of ``cases`` (name: kernel, plain version, library
    call or None, fresh outputs, the other tensors moved, MACs) at ``mode``:
    the error against the plain version (max error over the largest entry;
    by rel_norm for the ``rounded`` outputs in bf16), the control where
    ``ctrl`` holds the case (its plain version in mode f32 on the same
    inputs, which must read above the limit), and in mode ``timed`` device
    time, plain time, library time and bound (a ``rounded`` kernel's first
    output holds bfloat16 values: 2 bytes an entry), kept in ``rows`` with
    ``keep``. Prints every reading; appends a failure to ``fails``."""
    for name, (kern, plain, libc, fresh, moved, macs) in cases.items():
        ok_, op_ = fresh(), fresh()
        kern(ok_)
        plain(op_)
        torch.cuda.synchronize()
        by_norm = mode == "bf16" and name in rounded
        measure = rel_norm if by_norm else rel_max
        tol = ROUNDED_TOL if by_norm else KERNEL_TOL.get(mode, KERNEL_TOL["f32"])
        err = max(measure(a, b) for a, b in zip(ok_, op_))
        control = None
        if name in ctrl:
            oc = fresh()
            ctrl[name][1](oc)
            control = max(measure(a, b) for a, b in zip(oc, op_))
        line = (f"kernel {name} {label}, {mode}: {'rel_norm' if by_norm else 'max_rel_err'} "
                f"{err:.3e} (limit {tol:g}"
                + ("" if control is None else f", control {control:.3e}") + ")")
        if mode == timed:
            ms = device_ms(lambda i: kern(ok_))
            pms = device_ms(lambda i: plain(op_))
            lms = device_ms(lambda i: libc()) if libc is not None else None
            outs = [(t, 2) if name in rounded and mode == "bf16" and i == 0 else t
                    for i, t in enumerate(ok_)]
            nb = nbytes(*moved, *outs)
            bms, by = bound_ms(nb, macs, mode)
            line += (f" ms {ms:.4f} plain_ms {pms:.4f} library_ms "
                     f"{'null' if lms is None else f'{lms:.4f}'} bound_ms {bms:.4f} ({by}) "
                     f"share {bms / ms:.3f} bytes/s {nb / ms * 1e3:.4g}")
            if keep:
                rows[name] = {0: dict(max_abs_err=max(float((a - b).abs().max())
                                                      for a, b in zip(ok_, op_)),
                                      ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                                      bound_by=by)}
        log(line)
        if not (math.isfinite(err) and err <= tol and (control is None or control > tol)):
            fails.append((name, label, mode, err, control))


def check_estimator_kernels(cap, modes=("bf16", "f32")):
    """Phase 8: every kernel of the Neumann chain and the final pair vs its
    plain version on the captured inputs, per block kind and mode: error
    (relative to the largest entry; by rel_norm for the chain's bf16 stages,
    ROUNDED_OUTPUT), and in bf16 device time, plain time,
    bound, a cuDNN call's time at bf16 (the same product over both nets'
    examples with one net's kernel) and the control (the plain version in
    mode f32 on the same inputs against the bf16 one). Every reading is
    printed before the limits are checked. Returns the bf16 rows of the
    32x32 blocks with preact."""
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops.fused_solve import dswish

    F = torch.nn.functional
    rows, fails = {}, []
    for (c, preact), d in cap.items():
        B, _, H, W = d["args"][0].shape
        HW, Bt, dev = H * W, 2 * B, d["args"][0].device
        new = lambda *shape: torch.zeros(*shape, device=dev)
        act0 = "swish" if preact else "id"
        act1 = "dswish" if preact else "id"  # th1's transform
        for mode in modes:
            op, wt, Hs, E, ACC, ACCW = estimator_operands(d, mode)
            wt32 = ff._weights(d["datas"], "f32", torch.float32)
            S2f = op["S2"].float()  # nc_jt_in on float32 s (the merged path's)
            S0f = op["S0"].float()  # nc_jt_out_acc on float32 s
            mid = op["S1"].shape[1]
            W1o = fc.untile_w1t(op["W1T"], c, mid)  # OIHW, for the library call and bytes
            F1o = fc.untile_w1t(wt["w1t"], c, mid)  # the final pair's W1T, OIHW
            b0, b1, b2 = wt["beta"]
            beta1_x = wt["betas"][0, 1]  # net x's slope, on the card
            S, _ = ig.wgrad_splits(mid, mid, B, HW)
            # plain outputs first: each later kernel takes the plain result
            # of the one before as its input
            P = {k: new(Bt, mid, HW) for k in ("T2", "T1", "H1", "TH1", "H2", "TH2", "R2")}
            fc._nc_jt_in_plain(op["U"], op["W3T"], op["S2"], mode, P["T2"])
            fc._nc_jt_mid_plain(P["T2"], op["W2T"], op["S1"], mode, P["T1"], H, W)
            plain_in = ff._fp_conv_in_plain
            plain_mid = lambda *a: ff._fp_conv_mid_plain(*a, H, W)
            plain_in(Hs, None, wt["w1"], wt["b1"], b0, act0, mode, P["H1"])
            plain_in(E, Hs, wt["w1"], None, b0, act1, mode, P["TH1"])
            plain_mid(P["H1"], None, wt["w2"], wt["b2"], b1, "swish", mode, P["H2"])
            plain_mid(P["TH1"], P["H1"], wt["w2"], None, b1, "dswish", mode, P["TH2"])
            plain_in(ACCW, None, wt["w3t"], None, None, "id", mode, P["R2"])
            P["RP2"], P["RA"], P["RP1"] = (new(2, Bt, mid, HW) for _ in range(3))
            ff._fp_second_plain(P["R2"], None, P["H2"], P["TH2"], b2, P["RP2"][0],
                                P["RP2"][1], new(2, mid), new(2, mid))
            plain_mid(P["RP2"].view(2 * Bt, mid, HW), None, wt["w2t"], None, None, "id", mode,
                      P["RA"].view(2 * Bt, mid, HW))
            ff._fp_second_plain(P["RA"][0], P["RA"][1], P["H1"], P["TH1"], b1, P["RP1"][0],
                                P["RP1"][1], new(2, mid), new(2, mid))
            # the final pair's dW2 product rh2 x ta1 of net x (B-side dswish)
            wg = (P["RP2"][0][:B], None, None, P["TH1"][:B], P["H1"][:B], beta1_x,
                  "dswish", False)
            lib = lambda t: t.to(torch.bfloat16)  # the library call in bf16
            view = lambda t, ch: t.reshape(-1, ch, H, W)

            def cases(m, w):
                """name: (kernel, plain, library call, fresh outputs, the
                other tensors moved, MACs) at mode m with weights w. The
                chain's u, t2, t1 and kernels hold bfloat16 values in mode
                bf16 (stored in float32): counted at 2 bytes."""
                hv = lambda t: (t, 2) if m == "bf16" else t
                w2t2 = w["w2t"]  # the backward's four "nets"
                return {
                    "nc_jt_in": (
                        lambda o: fc.nc_jt_in(op["U"], op["W3T"], op["S2"], m, o[0]),
                        lambda o: fc._nc_jt_in_plain(op["U"], op["W3T"], op["S2"], m, o[0]),
                        lambda: F.conv2d(lib(op["U"]), lib(op["W3T"][0]), padding=1),
                        lambda: [new(Bt, mid, HW)], (hv(op["U"]), op["S2"], hv(op["W3T"])),
                        Bt * mid * c * 9 * HW),
                    **({"nc_jt_in (float32 s)": (
                        lambda o: fc.nc_jt_in(op["U"], op["W3T"], S2f, m, o[0]),
                        lambda o: fc._nc_jt_in_plain(op["U"], op["W3T"], S2f, m, o[0]),
                        None, lambda: [new(Bt, mid, HW)], (hv(op["U"]), S2f, hv(op["W3T"])),
                        Bt * mid * c * 9 * HW)} if mode == "bf16" else {}),
                    "nc_jt_mid": (
                        lambda o: fc.nc_jt_mid(P["T2"], op["W2T"], op["S1"], m, o[0], H, W),
                        lambda o: fc._nc_jt_mid_plain(P["T2"], op["W2T"], op["S1"], m, o[0], H, W),
                        lambda: F.conv2d(lib(view(P["T2"], mid)), lib(op["W2T"][0])),
                        lambda: [new(Bt, mid, HW)], (hv(P["T2"]), op["S1"], hv(op["W2T"])),
                        Bt * mid * mid * HW),
                    "nc_jt_out_acc": (
                        lambda o: fc.nc_jt_out_acc(P["T1"], op["W1T"], op["S0"], m, op["coeffs"],
                                                   0, o[0], o[1], H, W),
                        lambda o: fc._nc_jt_out_acc_plain(P["T1"], op["W1T"], op["S0"], m,
                                                          op["coeffs"], 0, o[0], o[1], H, W),
                        lambda: F.conv2d(lib(view(P["T1"], mid)), lib(W1o[0]), padding=1),
                        lambda: [new(Bt, c, H, W), op["ACC"].clone()],
                        (hv(P["T1"]), op["S0"], hv(W1o), op["ACC"]),
                        Bt * c * mid * 9 * HW),
                    **({"nc_jt_out_acc (float32 s)": (
                        lambda o: fc.nc_jt_out_acc(P["T1"], op["W1T"], S0f, m, op["coeffs"], 0,
                                                   o[0], o[1], H, W),
                        lambda o: fc._nc_jt_out_acc_plain(P["T1"], op["W1T"], S0f, m,
                                                          op["coeffs"], 0, o[0], o[1], H, W),
                        None, lambda: [new(Bt, c, H, W), op["ACC"].clone()],
                        (hv(P["T1"]), S0f, hv(W1o), op["ACC"]), Bt * c * mid * 9 * HW)}
                       if mode == "bf16" else {}),
                    "fp_conv_in": (
                        lambda o: ff.fp_conv_in(Hs, None, w["w1"], w["b1"], b0, act0, m, o[0]),
                        lambda o: plain_in(Hs, None, w["w1"], w["b1"], b0, act0, m, o[0]),
                        lambda: F.conv2d(lib(Hs), lib(w["w1"][0]), lib(w["b1"][0]), padding=1),
                        lambda: [new(Bt, mid, HW)], (Hs, w["w1"], w["b1"]),
                        Bt * mid * c * 9 * HW),
                    # the tangent th1 = W1 (eps swish'(h)) and the cotangent
                    # r2 = C3^T acc (times the loss cotangent, as the backward)
                    "fp_conv_in (th1)": (
                        lambda o: ff.fp_conv_in(E, Hs, w["w1"], None, b0, act1, m, o[0]),
                        lambda o: plain_in(E, Hs, w["w1"], None, b0, act1, m, o[0]),
                        lambda: F.conv2d(lib(E), lib(w["w1"][0]), padding=1),
                        lambda: [new(Bt, mid, HW)], (E, Hs if preact else None, w["w1"]),
                        Bt * mid * c * 9 * HW),
                    "fp_conv_in (r2)": (
                        lambda o: ff.fp_conv_in(ACCW, None, w["w3t"], None, None, "id", m, o[0]),
                        lambda o: plain_in(ACCW, None, w["w3t"], None, None, "id", m, o[0]),
                        lambda: F.conv2d(lib(ACCW), lib(w["w3t"][0]), padding=1),
                        lambda: [new(Bt, mid, HW)], (ACCW, w["w3t"]), Bt * mid * c * 9 * HW),
                    "fp_conv_mid": (
                        lambda o: ff.fp_conv_mid(P["TH1"], P["H1"], w["w2"], None, b1, "dswish",
                                                 m, o[0], H, W),
                        lambda o: plain_mid(P["TH1"], P["H1"], w["w2"], None, b1, "dswish", m,
                                            o[0]),
                        lambda: F.conv2d(lib(view(P["TH1"], mid)), lib(w["w2"][0])),
                        lambda: [new(Bt, mid, HW)], (P["TH1"], P["H1"], w["w2"]),
                        Bt * mid * mid * HW),
                    "fp_conv_mid (swish, h2)": (
                        lambda o: ff.fp_conv_mid(P["H1"], None, w["w2"], w["b2"], b1, "swish",
                                                 m, o[0], H, W),
                        lambda o: plain_mid(P["H1"], None, w["w2"], w["b2"], b1, "swish", m,
                                            o[0]),
                        lambda: F.conv2d(lib(view(P["H1"], mid)), lib(w["w2"][0]),
                                         lib(w["b2"][0])),
                        lambda: [new(Bt, mid, HW)], (P["H1"], w["w2"], w["b2"]),
                        Bt * mid * mid * HW),
                    "fp_conv_mid (id, 4 nets)": (
                        lambda o: ff.fp_conv_mid(P["RP2"].view(2 * Bt, mid, HW), None, w2t2,
                                                 None, None, "id", m, o[0], H, W),
                        lambda o: plain_mid(P["RP2"].view(2 * Bt, mid, HW), None, w2t2,
                                            None, None, "id", m, o[0]),
                        lambda: F.conv2d(lib(view(P["RP2"], mid)), lib(w["w2t"][0])),
                        lambda: [new(2 * Bt, mid, HW)], (P["RP2"], w2t2),
                        2 * Bt * mid * mid * HW),
                    "fp_conv_out": (
                        lambda o: ff.fp_conv_out(P["RP1"][1], w["w1t"], m, o[0], H, W),
                        lambda o: ff._fp_conv_out_plain(P["RP1"][1], w["w1t"], m, o[0], H, W),
                        lambda: F.conv2d(lib(view(P["RP1"][1], mid)), lib(F1o[0]), padding=1),
                        lambda: [new(Bt, c * HW)], (P["RP1"][1], hv(F1o)),
                        Bt * c * mid * 9 * HW),
                    # as the backward runs it under preact: rh1 and p_h1 of
                    # both nets, four "nets" on the two nets' kernels
                    "fp_conv_out (4 nets)": (
                        lambda o: ff.fp_conv_out(P["RP1"].view(2 * Bt, mid, HW), w["w1t"], m,
                                                 o[0], H, W, nets=4),
                        lambda o: ff._fp_conv_out_plain(P["RP1"].view(2 * Bt, mid, HW),
                                                        w["w1t"], m, o[0], H, W, nets=4),
                        lambda: F.conv2d(lib(view(P["RP1"], mid)), lib(F1o[0]), padding=1),
                        lambda: [new(2 * Bt, c * HW)], (P["RP1"], hv(F1o)),
                        2 * Bt * c * mid * 9 * HW),
                    "fp_tdot": (
                        lambda o: ff.fp_tdot(P["R2"], P["H2"], P["TH2"], b2, o[0]),
                        lambda o: ff._fp_tdot_plain(P["R2"], P["H2"], P["TH2"], b2, o[0]),
                        None, lambda: [new(Bt)], (P["R2"], P["H2"], P["TH2"]), 0),
                    "fp_second": (
                        lambda o: ff.fp_second(P["RA"][0], P["RA"][1], P["H1"], P["TH1"], b1, *o),
                        lambda o: ff._fp_second_plain(P["RA"][0], P["RA"][1], P["H1"], P["TH1"],
                                                      b1, *o),
                        None, lambda: [new(Bt, mid, HW), new(Bt, mid, HW), new(2, mid),
                                       new(2, mid)],
                        (P["RA"], P["H1"], P["TH1"]), 0),
                    "rv_wgrad (final pair)": (
                        lambda o: ig.rv_wgrad(*wg, m, o[0], H, W),
                        lambda o: ig._rv_wgrad_plain(*wg, m, o[0], H, W),
                        lambda: torch.nn.grad.conv2d_weight(
                            lib(view(P["TH1"][:B] * dswish(P["H1"][:B], beta1_x), mid)),
                            (mid, mid, 1, 1), lib(view(P["RP2"][0][:B], mid))),
                        lambda: [new(S, mid, mid)], (wg[0], wg[3], wg[4]),
                        mid * mid * B * HW),
                }

            ctrl = cases("f32", wt32) if mode != "f32" else {}
            check_cases(cases(mode, wt), {k: v for k, v in ctrl.items() if k not in NO_ROUNDING},
                        mode, f"c{c}{'' if preact else ' (no preact)'} ({H}x{W}, B={B} x 2 nets)",
                        rows, fails, timed="bf16", rounded=ROUNDED_OUTPUT,
                        keep=(c, preact) == (3, True))
            del S2f, S0f
    assert not fails, ("phase 8 (name, block, mode, error, control)", fails)
    return rows


def check_estimator_functions(cap):
    """Phase 9: the whole Neumann chain (the captured n_power) and the whole
    final pair (T, d_h = (d_x | d_z) and every gradient of both nets) vs
    their plain versions, per block kind and mode, by rel_norm (the chain's
    over acc - eps, the part the terms make) at CHAIN_TOL / FINAL_TOL; in
    bf16 beside the control (the plain version in mode f32 on the same
    inputs), which must lie above the limit for every output a product
    reaches. The final pair in mode bf16 is held against the plain path
    with fp_conv_mid and fp_conv_in summed exactly (ops/sum_order.py;
    FINAL_TOL's comment), beside its readings against the plain path and
    against the plain path with fp_conv_mid alone exact, and the sum-order
    floors of fp_conv_mid, fp_conv_in, rv_wgrad (5f) and fp_conv_out (5c:
    the reference with it summed exactly as well, against the reference),
    and the plain path with the kernels' orders of fp_conv_mid (K tiles of
    64) and fp_conv_in (float64 sums) against the reference, and the same
    with fp_conv_in in K tiles of 16 (the float32 order of EPI_AFFINE,
    which fp_conv_in does not take), and T of the reference with fp_tdot
    summed exactly or in its cluster kernel's order against the reference's
    (fp_tdot's floor). Every reading is printed before the limits are
    checked."""
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import sum_order as so
    from implicit_normalizing_flows_torch.ops.implicit_grad import DATA_KEYS

    fails = []
    for (c, preact), d in cap.items():
        label = f"c{c}{'' if preact else ' (no preact)'}"
        for mode in ("bf16", "f32"):
            dt = torch.bfloat16 if mode == "bf16" else torch.float32
            chains = [tuple(a.to(dt) for a in ch) for ch in d["chains"]]
            args = (*chains, d["signed"], d["n_power"])
            t0 = time.perf_counter()
            ak = fc.fused_neumann_chain2(*args)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t0
            t0 = time.perf_counter()
            ap = fc.fused_neumann_chain2_plain(*args)
            torch.cuda.synchronize()
            tp = time.perf_counter() - t0
            eps = [ch[0].float() for ch in chains]
            err = max(rel_norm(a, b, e) for a, b, e in zip(ak, ap, eps))
            control = floor = None
            if mode == "bf16":
                c32 = [tuple(a.float() for a in ch) for ch in chains]
                ac = fc.fused_neumann_chain2_plain(*c32, d["signed"], d["n_power"])
                control = min(rel_norm(a, b, e) for a, b, e in zip(ac, ap, eps))
                floor = {}
                for what, exact in (
                        ("nc_jt_in", dict(nc_jt_in=so.nc_jt_in_exact)),
                        ("nc_jt_out_acc", dict(nc_jt_out_acc=so.nc_jt_out_acc_exact)),
                        ("nc_jt_in and nc_jt_out_acc", dict(
                            nc_jt_in=so.nc_jt_in_exact, nc_jt_out_acc=so.nc_jt_out_acc_exact))):
                    ax = fc._chain(chains, d["signed"], d["n_power"], dict(fc._PLAIN, **exact))
                    floor[what] = max(rel_norm(a, b, e) for a, b, e in zip(ax, ap, eps))
                    del ax
            log(f"neumann chain {label} {mode} n_power {d['n_power']}: rel_norm {err:.3e} "
                f"(limit {CHAIN_TOL[mode]:g}"
                + ("" if control is None else f", control {control:.3e}; sum-order floors (the "
                   "plain chain with products summed exactly against the plain chain): "
                   + ", ".join(f"{w} exact {v:.3e}" for w, v in floor.items()))
                + f") s {tk:.3f}/{tp:.3f} (kernels/plain)")
            assert all(bool(torch.isfinite(a).all()) for a in ak)
            if not (err <= CHAIN_TOL[mode] and (control is None or control > CHAIN_TOL[mode])):
                fails.append(("chain", c, preact, mode, err, control))

            def pair(ops, m, w):
                Hs, E, ACC, ACCW = pair_inputs(d)
                T = ff._primal(ops, m, w, Hs, E, ACC, preact)
                d_h, g = ff._backward(ops, m, w, Hs, E, ACCW, preact, d["datas"])
                return [("T", T), ("d_h", d_h)] + [
                    (f"{n}.{k}", g[i][k]) for i, n in enumerate("xz") for k in DATA_KEYS]

            wt = ff._weights(d["datas"], mode, torch.float32)
            t0 = time.perf_counter()
            gk = pair(ff._OPS, mode, wt)
            torch.cuda.synchronize()
            tk = time.perf_counter() - t0
            t0 = time.perf_counter()
            gp = pair(ff._PLAIN, mode, wt)
            torch.cuda.synchronize()
            tp = time.perf_counter() - t0
            # mode bf16's reference: the plain path with fp_conv_mid and
            # fp_conv_in summed exactly (FINAL_TOL's comment); mode f32's: the
            # plain path
            exact = lambda **k: pair(dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_exact, **k),
                                     mode, wt)
            ref = exact(fp_conv_in=so.fp_conv_in_exact) if mode == "bf16" else gp
            vs = lambda g, r: max((rel_norm(a, b), n) for (n, a), (_, b) in zip(g, r))
            worst = vs(gk, ref)
            line = f"final pair {label} {mode}: worst rel_norm {worst[0]:.3e} ({worst[1]})"
            ctrl = None
            if mode == "bf16":
                gc = pair(ff._PLAIN, "f32", ff._weights(d["datas"], "f32", torch.float32))
                ctrl = min((rel_norm(a, b), n) for (n, a), (_, b) in zip(gc, ref)
                           if not n.endswith(".b3"))
                mid_ref = exact()  # PRs 8-13's reference: fp_conv_mid alone exact
                old, old_ref = vs(gk, gp), vs(gk, mid_ref)
                floor, fin = vs(gp, mid_ref), vs(mid_ref, ref)
                wg = vs(pair(dict(ff._PLAIN, rv_wgrad=so.rv_wgrad_exact), mode, wt), gp)
                out = vs(exact(fp_conv_in=so.fp_conv_in_exact, fp_conv_out=so.fp_conv_out_exact),
                         ref)
                # the kernels' orders: 5b by K tiles of 64, 5a in float64;
                # and 5a by K tiles of 16, the float32 order it does not take
                order = vs(pair(dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_tiled,
                                     fp_conv_in=so.fp_conv_in_exact), mode, wt), ref)
                f32_in = vs(pair(dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_tiled,
                                      fp_conv_in=so.fp_conv_in_tiled), mode, wt), ref)
                # T, the pair's scalar: the reference's T with fp_tdot summed
                # exactly or in its cluster kernel's order, beside the kernels'
                ref_ops = dict(ff._PLAIN, fp_conv_mid=so.fp_conv_mid_exact,
                               fp_conv_in=so.fp_conv_in_exact)
                T_of = lambda ops: ff._primal(ops, mode, wt, *pair_inputs(d)[:3], preact)
                t_ref = T_of(ref_ops)
                t_floor = {what: rel_norm(T_of(dict(ref_ops, fp_tdot=f)), t_ref)
                           for what, f in (("summed exactly", so.fp_tdot_exact),
                                           ("in its kernel's order", so.fp_tdot_tiled))}
                line += (f" against the plain path with fp_conv_mid and fp_conv_in exact (limit "
                         f"{FINAL_TOL[mode]:g}, least control {ctrl[0]:.3e} ({ctrl[1]})); "
                         f"against the plain path {old[0]:.3e} ({old[1]}); against the plain "
                         f"path with fp_conv_mid exact {old_ref[0]:.3e} ({old_ref[1]}); "
                         f"sum-order floors: fp_conv_mid (plain against its exact sums) "
                         f"{floor[0]:.3e} ({floor[1]}), fp_conv_in (fp_conv_mid exact against "
                         f"the reference) {fin[0]:.3e} ({fin[1]}), rv_wgrad exact {wg[0]:.3e} "
                         f"({wg[1]}), against the reference with fp_conv_out exact as well "
                         f"{out[0]:.3e} ({out[1]}), the plain path with fp_conv_mid in its "
                         f"kernel's order and fp_conv_in exact (the kernels' orders) against the "
                         f"reference {order[0]:.3e} ({order[1]}), with fp_conv_in in K tiles of "
                         f"16 (float32 sums) instead {f32_in[0]:.3e} ({f32_in[1]}); T: the "
                         f"kernels against the reference {rel_norm(gk[0][1], ref[0][1]):.3e}, "
                         f"the reference with fp_tdot "
                         + ", ".join(f"{w} {v:.3e}" for w, v in t_floor.items()))
            log(line + f" s {tk:.3f}/{tp:.3f} (kernels/plain)")
            for n, a in gk:
                assert torch.isfinite(a).all(), n
            if not (worst[0] <= FINAL_TOL[mode] and (ctrl is None or ctrl[0] > FINAL_TOL[mode])):
                fails.append(("final pair", c, preact, mode, worst, ctrl))
    assert not fails, ("phase 9 (function, c, preact, mode, error, control)", fails)


def kernel_modules():
    """(library, module, TPU kernel of each wrapper name) of every kernel."""
    from implicit_normalizing_flows_torch.ops import broyden_update as bu
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops import line_search as lsm

    return [("fused_solve", fs, lambda n: TPU_SOLVE),
            ("fused_solve", lsm, lambda n: TPU_SEARCH),
            ("block_forward", fb, lambda n: TPU_BLOCK),
            ("implicit_grad", ig, lambda n: TPU_BWD if n.startswith("jt_") else TPU_REATTACH),
            ("estimator", fc, lambda n: TPU_CHAIN),
            ("estimator", ff, lambda n: TPU_FINAL),
            ("broyden_update", bu, lambda n: TPU_UPDATE)]


def launch_counts():
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    from implicit_normalizing_flows_torch.ops import fused_block as fb

    counts = {k: v for _, m, _ in kernel_modules() for k, v in m.launch_counts().items()}
    counts[TC_SPLIT] = fs.conv1x1_mid.tc_launches
    counts[TC_LIN] = fb.lin_conv1x1_mid.tc_launches
    counts[TC_LIN3] = fb.lin_conv3x3_in.tc_launches
    counts[TC_IN] = fs.conv3x3_in.tc_launches
    counts[TC_OUT] = fs.conv3x3_out.tc_launches
    return counts


def reset_launch_counts():
    for _, m, _ in kernel_modules():
        m.reset_launch_counts()


def train_steps(step, x_u8, draws, n0, n):
    """n training steps with per-step metrics and host-clock ms."""
    out = []
    for i in range(n0, n0 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(x_u8, draws(i))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        vals = {k: float(v) for k, v in m.items()}
        log(f"train step {i}: loss {vals['loss']:.5f} bpd {vals['bpd']:.5f} "
            f"grad_norm {vals['grad_norm']:.4f} nstep {vals['broyden_nstep']:.2f} "
            f"converged {vals['broyden_converged']:.3f} "
            f"conv3eps {vals['broyden_converged_3eps']:.3f} "
            f"rms_over_tol {vals['broyden_rms_over_tol']:.3f} "
            f"est_firmom {vals['est_firmom']:.3f} ms {ms:.1f}")
        assert all(math.isfinite(v) for v in vals.values()), vals
        assert 1.0 < vals["bpd"] < 8.0, vals["bpd"]
        out.append((vals, ms))
    return out


@contextlib.contextmanager
def patched(changes):
    """Set ``owner.name = value`` for each (owner, name, value) for the
    duration, then restore what was there."""
    saved = [(o, n, getattr(o, n)) for o, n, _ in changes]
    for o, n, v in changes:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in reversed(saved):
            setattr(o, n, v)


def train_parts(model, step, estimator, merged=False):
    """(owner, name, part) of the functions a training step's breakdown
    times: [the merged forwards and the final terms,] the forward solves,
    [the chains and the final pair's primal and backward,] backward solves,
    re-attachment VJPs and the update (optimizer, power iteration)."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock, implicit_block
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import logdet as ld

    parts = [(implicit_block, "fused_block_forward", "merged_forwards"),
             (ld, "neumann_final", "final_terms")] if merged else []
    parts += [(ImplicitBlock, "solve", "solve")]
    if estimator:
        parts += [(fc, "fused_neumann_chain2", "chains"),
                  (ff, "_primal", "final_primal"), (ff, "_backward", "final_backward")]
    return parts + [(ImplicitBlock, "backward_solve", "backward_solve"),
                    (implicit_block, "fused_reattach_vjp", "reattach"),
                    (step.optimizer, "update", "update"),
                    (type(model), "update_lipschitz", "update")]


def breakdown_step(step, x_u8, draws, parts, rest):
    """One training step with each part of ``parts`` (owner, name, key)
    timed on the host clock between synchronisations; ``rest`` names what
    is left (dequantise, EMA, autograd and whatever no part covers)."""
    acc = {key: 0.0 for _, _, key in parts}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[key] += 1e3 * (time.perf_counter() - t)
            return out
        return run

    with patched([(o, n, timed(key, getattr(o, n))) for o, n, key in parts]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x_u8, draws)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    log(f"train breakdown (host clock, synchronised): wall {wall:.1f} ms = " + ", ".join(
        f"{k} {v:.1f}" for k, v in acc.items()) + f", {rest} {wall - sum(acc.values()):.1f}")


def profile_train_step(step, x_u8, draws):
    """Device time by kernel over one training step and the device's idle
    share (1 - busy time / wall time, :func:`device_busy`); returns the
    kernels' profiler records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x_u8, draws)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = _kernel_events(prof)
    total, busy, span = device_busy(prof)
    ours = sum(_self_ms(e) for e in events if is_port_kernel(e.key))
    log(f"profile train step: wall {wall:.1f} ms, device busy {busy:.1f} ms (summed "
        f"{total:.1f}, span {span:.1f}), idle share {1 - busy / wall:.3f}, port kernels "
        f"{ours:.1f} ms, other device work {total - ours:.1f} ms")
    for e in sorted(events, key=_self_ms, reverse=True)[:20]:
        log(f"  {_self_ms(e):9.2f} ms  x{e.count:<5d} {e.key[:110]}")
    return events


def check_tensor_core_route(events, launched):
    """A profiled run ran each wrapper of ``launched`` (its tensor-core
    launches in that run) on its kernel (ROUTES: the tensor-core kernels
    and the cluster-split reductions): the
    kernel's records (name, rank among the run's kernels by time, time,
    launches recorded), as many launches recorded as the wrapper made (the
    wrappers of a SHARED_TC group together), and no record of a CUDA-core
    instantiation they replaced (asserted). Returns the counts that differ,
    (names, recorded, launched): the profiler now and then loses a stretch
    of a long step's records (device_ms), which reads as too few."""
    ranked = sorted(events, key=_self_ms, reverse=True)
    old = [e.key for e in events if REPLACED_SIMT.search(e.key)]
    groups = [g for g in (tuple(n for n in grp if n in launched) for grp in SHARED_TC) if g]
    groups += [(n,) for n in launched if not any(n in g for g in groups)]
    fails = []
    for group in groups:
        pattern = re.compile("|".join(ROUTES[n][0].pattern for n in group))
        tc = [(i + 1, e) for i, e in enumerate(ranked) if pattern.search(e.key)]
        names = " + ".join(group)
        for rank, e in tc:
            log(f"route of {names}: rank {rank}, {_self_ms(e):.2f} ms x{e.count} "
                f"{e.key[:140]}")
        recorded, n = sum(e.count for _, e in tc), sum(launched[k] for k in group)
        log(f"route of {names}: {recorded} launches recorded, {n} by the wrapper"
            + ("s" if len(group) > 1 else ""))
        if not (all(launched[k] > 0 for k in group) and n == recorded):
            fails.append((names, recorded, n))
    log(f"replaced CUDA-core instantiations recorded: {len(old)}")
    assert not old, old[:3]
    return fails


def routes_of(delta, names):
    """The launches each route of ``names`` is held to, from a run's launch
    counts ``delta`` (TC_COUNT)."""
    return {k: delta[TC_COUNT.get(k, k)] for k in names}


def profiled_routes(run, names, label):
    """Profile ``run()`` (which returns the kernels' records) up to
    ROUTE_ATTEMPTS times, until one record holds every route of ``names``
    exactly (a record holds a launch that ran and never one that did not,
    so one exact record shows the routes); asserts that one did."""
    for attempt in range(1, ROUTE_ATTEMPTS + 1):
        before = launch_counts()
        events = run()
        after = launch_counts()
        fails = check_tensor_core_route(
            events, routes_of({k: after[k] - before[k] for k in after}, names))
        log(f"profiled run {attempt} of at most {ROUTE_ATTEMPTS} ({label}): counts that "
            f"differ (names, recorded, launched) {fails}")
        if not fails:
            return
    assert not fails, fails


def plain_versions(estimator, merged=False):
    """(owner, name, plain version) of every whole function of a training
    step: the forward and backward solves, the re-attachment VJP [, the
    Neumann chain and the final pair] [, the merged forward]."""
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    out = [(implicit_block, "fused_broyden_solve", fs.fused_broyden_solve_plain),
           (implicit_block, "fused_backward_solve", ig.fused_backward_solve_plain),
           (implicit_block, "fused_reattach_vjp", ig.fused_reattach_vjp_plain)]
    if estimator:
        out += [(fc, "fused_neumann_chain2", fc.fused_neumann_chain2_plain),
                (implicit_block, "fused_final_pair", ff.fused_final_pair_plain)]
    if merged:
        out += [(implicit_block, "fused_block_forward", fb.fused_block_forward_plain)]
    return out


def compare_plain_step(step, x_u8, draws, plain, dl_max=1e-3):
    """One step's loss and gradients with the kernels and with every plain
    version of ``plain`` (owner, name, plain version) forced, from the same
    state and draws: |d loss| <= dl_max, every gradient's cosine >= 0.999,
    a tensor's norm within 1e-3 and a scalar's within 2e-2."""
    lk, _, gk = step.grads(x_u8, draws())
    with patched(plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, _, gp = step.grads(x_u8, draws())
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
    dl = abs(float(lk) - float(lp))
    # the cosine sees the direction of each gradient, the norm ratio its
    # scale (a doubled dW2 or a lost alpha). A scalar's cosine is 1 and its
    # ratio is its relative error: the swish slopes' gradients are sums over
    # the batch and every pixel that cancel to a small fraction of their
    # terms, so the two paths' forward solves (their iterates differ by
    # about 1e-4 in tf32) move them by up to about 0.5%.
    cos, ratio = {}, {}
    for k in gk:
        a, b = gk[k].double().flatten(), gp[k].double().flatten()
        if float(b.norm()) == 0.0 and float(a.norm()) == 0.0:
            continue  # geom_p, lamb: outside the loss's reach
        cos[k] = float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
        ratio[k] = abs(float(a.norm() / b.norm().clamp(min=1e-300)) - 1.0)
    worst = min(cos, key=cos.get)
    tensors = [k for k in ratio if gk[k].numel() > 1]
    scalars = [k for k in ratio if gk[k].numel() == 1]
    wt = max(tensors, key=ratio.get)
    ws = max(scalars, key=ratio.get) if scalars else None
    log(f"plain path train step: loss {float(lp):.6f} vs {float(lk):.6f} |d loss| {dl:.2e}, "
        f"min gradient cosine {cos[worst]:.6f} ({worst}), max |norm ratio - 1| "
        f"{ratio[wt]:.2e} ({wt})"
        + (f", of a scalar {ratio[ws]:.2e} ({ws})" if ws else "")
        + f", plain grads {pms:.1f} ms")
    assert dl <= dl_max, dl
    assert cos[worst] >= 0.999, (worst, cos[worst])
    assert ratio[wt] <= 1e-3, (wt, ratio[wt])
    assert ws is None or ratio[ws] <= 2e-2, (ws, ratio[ws])


# ---------------------------------------------------------------------------
# phases 14-16: the merged block forward (IMNF_FUSED_BLOCK=1)

@contextlib.contextmanager
def environ(**values):
    """Set the environment variables for the duration, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def capture_block_forward_inputs(step, x_u8, draws):
    """The merged forward's real inputs at each scale's last block, from one
    training step's gradient with every block merged (min_hw 0, so the 8x8
    blocks give theirs too) and every plain version forced (plain_versions:
    a block's input comes out of the earlier blocks' merged forwards), so
    that the inputs, and the floors phases 14-15 read on them, do not move
    with the port's kernels: {c: dict(args=(x, data_x, data_z, eps_x, eps_z,
    signed, n_power), kw=the solver's arguments)}."""
    from implicit_normalizing_flows_torch.layers import implicit_block

    seen = {}
    det = lambda v: ({k: det(a) for k, a in v.items()} if isinstance(v, dict)
                     else v.detach().clone() if torch.is_tensor(v) else v)

    with environ(IMNF_FUSED_BLOCK="1", IMNF_FUSED_SOLVE_MIN_HW="0"), \
            patched(plain_versions(True, merged=True)):
        fwd = implicit_block.fused_block_forward  # the plain version

        def rec(*args, **kw):
            seen[args[0].shape[1]] = dict(args=tuple(det(a) for a in args), kw=kw)
            return fwd(*args, **kw)

        with patched([(implicit_block, "fused_block_forward", rec)]):
            step.grads(x_u8, draws)
    return dict(sorted(seen.items()))


def block_operands(d, mode):
    """A captured block's linearisation (the plain solve in ``mode`` with its
    ladder) and both nets' chain operands, stacked, in the chain dtype of
    ``mode``."""
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    x, data_x, data_z, eps_x, eps_z, signed, _ = d["args"]
    kw = dict(d["kw"], mode=mode)
    if mode == "f32":
        kw.update(tail_mode=None, tail_start=None)
    # the plain solve's linearisation: the port's kernels do not move it
    _, lin = fs._solve(x, data_x, data_z, fb._PLAIN_OPS, linearise=True, **kw)
    return lin, fc.chain_operands(fb.chains(data_x, data_z, eps_x, eps_z, lin, mode), signed)


def check_block_kernels(cap):
    """Phase 14: the merged forward's kernels vs their plain versions on the
    captured inputs, per scale: the linearisation variants (net x at x, its
    phase-1 evaluation; both outputs: swish(h) and s) in tf32 (the main
    path's mode, timed and kept), tf32x (timed; lin_conv1x1_mid runs both on
    the tensor cores), bf16 (with the control: the plain version in mode f32
    on the same inputs) and f32, and on the precision probe (phase 2's);
    the chain's nc_jt_* kernels (phase 8's) on the merged path's float32 s
    factors of both nets in bf16 (timed, with the control) and f32. Errors
    as phases 2 and 8: max error over the largest entry, by rel_norm for the
    bf16 chain stages (ROUNDED_OUTPUT). Every reading is printed before the
    limits are checked. Returns the linearisation kernels' timed rows of the
    32x32 blocks (the chain's rows are phase 8's)."""
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    F = torch.nn.functional
    rows, fails = {}, []
    for c, d in cap.items():
        x, data_x = d["args"][0], d["args"][1]
        B, _, H, W = x.shape
        HW, D, dev = H * W, c * H * W, x.device
        new = lambda *shape: torch.zeros(*shape, device=dev)
        preact = bool(data_x["preact"])
        betas = [float(v) for v in data_x["betas"].cpu()]
        b1, b2 = (data_x[k].detach().float().contiguous() for k in ("b1", "b2"))
        w1, w2 = (data_x[k].detach().float() for k in ("w1", "w2"))
        view = lambda t, ch: t.reshape(-1, ch, H, W)
        for mode in ("tf32", "tf32x", "bf16", "f32"):
            wp = fs.prep_weights(data_x, mode)
            mid = w2.shape[0]
            t1 = new(B, mid, HW)  # the plain t1: conv1x1's input
            fb._lin_conv3x3_in_plain(x, wp["w1"], b1, betas, preact, mode, t1, new(B, mid, HW),
                                     new(B, D))
            s0 = lambda o: o[2] if preact else None  # s0 is written under preact only

            def cases(m):
                wm = fs.prep_weights(data_x, m)
                return {
                    # in tf32 / tf32x on the tensor cores: W1's bf16 halves
                    "lin_conv3x3_in": (
                        lambda o: fb.lin_conv3x3_in(x, wm["w1_in"], b1, betas, preact, m, o[0],
                                                    o[1], s0(o)),
                        lambda o: fb._lin_conv3x3_in_plain(x, wm["w1_in"], b1, betas, preact,
                                                           m, o[0], o[1], s0(o)),
                        lambda: F.conv2d(x, w1, b1, padding=1),
                        lambda: [new(B, mid, HW), new(B, mid, HW)] + [new(B, D)] * preact,
                        (x, *(w for w in wm["w1_in"] if w is not None), b1),
                        B * mid * c * 9 * HW),
                    # in tf32 / tf32x on the tensor cores: W2's bf16 halves
                    "lin_conv1x1_mid": (
                        lambda o: fb.lin_conv1x1_mid(t1, wm["w2_mid"], b2, betas[2], m, *o, H,
                                                     W),
                        lambda o: fb._lin_conv1x1_mid_plain(t1, wm["w2_mid"], b2, betas[2], m,
                                                            *o, H, W),
                        lambda: F.conv2d(view(t1, mid), w2, b2),
                        lambda: [new(B, mid, HW), new(B, mid, HW)],
                        (t1, *(w for w in wm["w2_mid"] if w is not None), b2),
                        B * mid * mid * HW),
                }

            check_cases(cases(mode), cases("f32") if mode == "bf16" else {}, mode,
                        f"c{c} ({H}x{W}, B={B})", rows, fails,
                        timed=mode if mode in fs.SPLIT_MODES else None,
                        keep=c == 3 and mode == "tf32")
        # the linearisation kernels on the precision probe (no preact: the
        # probe's x is the conv's operand)
        PB = PROBE_BATCH

        def lin_in(f):
            def run(m, xx, w):
                o = [torch.zeros(PB, mid, HW, device=dev) for _ in range(2)]
                f(xx, fs.prep_conv1x1_mid(fs.prep_weight(w, m), m),
                  torch.zeros(mid, device=dev), [1.0] * 3, False, m, *o, None)
                return o
            return run

        def lin_mid(f):
            def run(m, t, w):
                o = [torch.zeros(PB, mid, HW, device=dev) for _ in range(2)]
                f(t, fs.prep_conv1x1_mid(fs.prep_weight(w, m), m), torch.zeros(mid, device=dev),
                  1.0, m, *o, H, W)
                return o
            return run

        x1, w1p = probe_operands(PB, c, mid, H, W, 3, 10 + c, dev)
        t1p, w2p = probe_operands(PB, mid, mid, H, W, 1, 10 + c, dev)
        check_tf32_probe({
            "lin_conv3x3_in": (lin_in(fb.lin_conv3x3_in), lin_in(fb._lin_conv3x3_in_plain),
                               x1, w1p),
            "lin_conv1x1_mid": (lin_mid(fb.lin_conv1x1_mid), lin_mid(fb._lin_conv1x1_mid_plain),
                                t1p.reshape(PB, mid, HW), w2p),
        }, f"c{c} ({H}x{W}, B={PB})", rel_max, KERNEL_TOL["f32"], fails)
        for mode in ("bf16", "f32"):
            _, op = block_operands(d, "tf32" if mode == "bf16" else "f32")
            Bt, mid = op["U"].shape[0], op["S1"].shape[1]
            W1o = fc.untile_w1t(op["W1T"], c, mid)
            T2, T1 = new(Bt, mid, HW), new(Bt, mid, HW)
            fc._nc_jt_in_plain(op["U"], op["W3T"], op["S2"], mode, T2)
            fc._nc_jt_mid_plain(T2, op["W2T"], op["S1"], mode, T1, H, W)
            lib = lambda t: t.to(torch.bfloat16)

            def cases(m):
                hv = lambda t: (t, 2) if m == "bf16" else t
                return {
                    "nc_jt_in": (
                        lambda o: fc.nc_jt_in(op["U"], op["W3T"], op["S2"], m, o[0]),
                        lambda o: fc._nc_jt_in_plain(op["U"], op["W3T"], op["S2"], m, o[0]),
                        lambda: F.conv2d(lib(op["U"]), lib(op["W3T"][0]), padding=1),
                        lambda: [new(Bt, mid, HW)], (hv(op["U"]), op["S2"], hv(op["W3T"])),
                        Bt * mid * c * 9 * HW),
                    "nc_jt_mid": (
                        lambda o: fc.nc_jt_mid(T2, op["W2T"], op["S1"], m, o[0], H, W),
                        lambda o: fc._nc_jt_mid_plain(T2, op["W2T"], op["S1"], m, o[0], H, W),
                        lambda: F.conv2d(lib(view(T2, mid)), lib(op["W2T"][0])),
                        lambda: [new(Bt, mid, HW)], (hv(T2), op["S1"], hv(op["W2T"])),
                        Bt * mid * mid * HW),
                    "nc_jt_out_acc": (
                        lambda o: fc.nc_jt_out_acc(T1, op["W1T"], op["S0"], m, op["coeffs"], 0,
                                                   o[0], o[1], H, W),
                        lambda o: fc._nc_jt_out_acc_plain(T1, op["W1T"], op["S0"], m,
                                                          op["coeffs"], 0, o[0], o[1], H, W),
                        lambda: F.conv2d(lib(view(T1, mid)), lib(W1o[0]), padding=1),
                        lambda: [new(Bt, c, H, W), op["ACC"].clone()],
                        (hv(T1), op["S0"], hv(W1o), op["ACC"]), Bt * c * mid * 9 * HW),
                }

            check_cases(cases(mode), cases("f32") if mode == "bf16" else {}, mode,
                        f"c{c} ({H}x{W}, B={B} x 2 nets, float32 s)", rows, fails,
                        timed="bf16", rounded=ROUNDED_OUTPUT)
            del op
    assert not fails, ("phase 14 (name, block, mode, error, control)", fails)
    return rows


NARROW_MIDS = (64, 192, 384)  # mid % 64 == 0, some not a multiple of a 128-row chunk


def check_conv3x3_in_widths(dev, batch=4):
    """Phase 14's tail: the c -> mid tensor-core kernel at mid NARROW_MIDS,
    where the M chunks do not split evenly over the groups of blocks and
    the last chunk at 8x8 is half full: nc_jt_in (bf16, two nets of
    ``batch`` examples, s2 bfloat16; rel_norm against ROUNDED_TOL),
    lin_conv3x3_in (tf32, tf32x, preact; its three outputs, max error over
    the largest entry against SPLIT_TOL), the solve's conv3x3_in (tf32,
    tf32x, preact, every slot live; against SPLIT_TOL) and the backward
    solve's jt_conv3x3_in (bf16, s2 bfloat16, every slot live under a
    permuted idx; against KERNEL_TOL), the final pair's fp_conv_in (bf16,
    two nets with their own slopes and biases: h1's swish and th1's swish';
    against KERNEL_TOL) and the re-attachment's rv_conv3x3_in (bf16, every
    slot live under a permuted idx: h1's swish and bias, t2's alpha -1;
    against KERNEL_TOL); and the mid -> c kernel's
    conv3x3_out (the forward solve's C3_SOLVE form, tf32 and tf32x, net z's
    residual, every slot live under a permuted idx; against SPLIT_TOL),
    nc_jt_out_acc (bf16, two nets, s0 bfloat16; u by rel_norm against
    ROUNDED_TOL, acc += c_k u by rel_norm of its update over the update)
    and fp_conv_out (bf16, four nets on two nets' kernels; against
    KERNEL_TOL), against their plain versions on seeded random inputs at
    each scale's c and image. The kernels' outputs (u, not acc) start as
    NaN, so an output left unwritten reads NaN and fails. Every reading is
    printed before the limits are checked."""
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import fused_final as ff
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig

    g = torch.Generator(device=dev).manual_seed(11)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    nan = lambda *shape: torch.full(shape, float("nan"), device=dev)
    fails = []
    for c, H in ((3, 32), (12, 16), (48, 8)):
        HW = H * H
        for mid in NARROW_MIDS:
            label = f"c{c} ({H}x{H}, mid {mid})"
            u = r(2 * batch, c, H, H).to(torch.bfloat16).float()
            w3t = (0.1 * r(2, mid, c, 3, 3)).to(torch.bfloat16)
            s2 = (0.5 + torch.rand(2 * batch, mid, HW, generator=g, device=dev)).to(
                torch.bfloat16)
            ok_, op_ = nan(2 * batch, mid, HW), nan(2 * batch, mid, HW)
            fc.nc_jt_in(u, w3t, s2, "bf16", ok_)
            fc._nc_jt_in_plain(u, w3t, s2, "bf16", op_)
            torch.cuda.synchronize()
            err = rel_norm(ok_, op_)
            log(f"kernel nc_jt_in {label}, bf16: rel_norm {err:.3e} (limit {ROUNDED_TOL:g})")
            if not (math.isfinite(err) and err <= ROUNDED_TOL):
                fails.append(("nc_jt_in", label, "bf16", err))
            x, w1, b1 = r(batch, c, H, H), 0.1 * r(mid, c, 3, 3), 0.1 * r(mid)
            for mode in fs.SPLIT_MODES:
                wk = fs.prep_conv1x1_mid(fs.prep_weight(w1, mode), mode)
                outs = [[nan(batch, mid, HW), nan(batch, mid, HW), nan(batch, c * HW)]
                        for _ in range(2)]
                for f, o in ((fb.lin_conv3x3_in, outs[0]), (fb._lin_conv3x3_in_plain, outs[1])):
                    f(x, wk, b1, [1.1, 0.9, 1.0], True, mode, *o)
                torch.cuda.synchronize()
                err = max(rel_max(a, b) for a, b in zip(*outs))
                log(f"kernel lin_conv3x3_in {label}, {mode}: max_rel_err {err:.3e} "
                    f"(limit {SPLIT_TOL:g})")
                if not (math.isfinite(err) and err <= SPLIT_TOL):
                    fails.append(("lin_conv3x3_in", label, mode, err))
                idx = torch.arange(batch, dtype=torch.int32, device=dev)
                cnt = torch.full((1,), batch, dtype=torch.int32, device=dev)
                outs = [nan(batch, mid, HW) for _ in range(2)]
                for f, o in ((fs.conv3x3_in, outs[0]), (fs._conv3x3_in_plain, outs[1])):
                    f(x, idx, cnt, wk, b1, [1.1, 0.9, 1.0], True, mode, o)
                torch.cuda.synchronize()
                err = rel_max(*outs)
                log(f"kernel conv3x3_in {label}, {mode}: max_rel_err {err:.3e} "
                    f"(limit {SPLIT_TOL:g})")
                if not (math.isfinite(err) and err <= SPLIT_TOL):
                    fails.append(("conv3x3_in", label, mode, err))
            # the solve's conv3x3_out (C3_SOLVE: a band's output tiles over
            # C3_SOLVE_GROUPS blocks), net z's residual, every slot live
            # under a permuted idx
            t2, w3 = r(batch, mid, HW), 0.02 * r(c, mid, 3, 3)
            b3, base, sub = 0.1 * r(c), r(batch, c * HW), r(batch, c * HW)
            pidx = torch.randperm(batch, generator=g, device=dev).to(torch.int32)
            pcnt = torch.full((1,), batch, dtype=torch.int32, device=dev)
            for mode in fs.SPLIT_MODES:
                wk = fs.prep_conv3x3_out(fs.prep_weight(w3, mode), mode)
                outs = [nan(batch, c * HW) for _ in range(2)]
                for f, o in ((fs.conv3x3_out, outs[0]), (fs._conv3x3_out_plain, outs[1])):
                    f(t2, pidx, pcnt, wk, b3, mode, base, -1.0, sub, o, H, H)
                torch.cuda.synchronize()
                err = rel_max(*outs)
                log(f"kernel conv3x3_out {label}, {mode}: max_rel_err {err:.3e} "
                    f"(limit {SPLIT_TOL:g})")
                if not (math.isfinite(err) and err <= SPLIT_TOL):
                    fails.append(("conv3x3_out", label, mode, err))
            t = r(2 * batch, mid, HW).to(torch.bfloat16).float()
            w1t = fc.tile_w1t((0.05 * r(2, c, mid, 3, 3)).to(torch.bfloat16))
            s0 = (0.5 + torch.rand(2 * batch, c * HW, generator=g, device=dev)).to(torch.bfloat16)
            coef, acc0 = torch.tensor([0.5, -0.25], device=dev), r(2 * batch, c * HW)
            outs = [(nan(2 * batch, c, H, H), acc0.clone()) for _ in range(2)]
            for f, (uo, ao) in ((fc.nc_jt_out_acc, outs[0]), (fc._nc_jt_out_acc_plain, outs[1])):
                f(t, w1t, s0, "bf16", coef, 1, uo, ao, H, H)
            torch.cuda.synchronize()
            err = max(rel_norm(outs[0][0], outs[1][0]), rel_norm(outs[0][1], outs[1][1], acc0))
            log(f"kernel nc_jt_out_acc {label}, bf16: rel_norm {err:.3e} (limit "
                f"{ROUNDED_TOL:g})")
            if not (math.isfinite(err) and err <= ROUNDED_TOL):
                fails.append(("nc_jt_out_acc", label, "bf16", err))
            tol = KERNEL_TOL["bf16"]
            # jt_conv3x3_in: slot s reads example idx[s] (u and s2)
            idx = torch.randperm(batch, generator=g, device=dev).to(torch.int32)
            cnt = torch.full((1,), batch, dtype=torch.int32, device=dev)
            w3t = (0.1 * r(mid, c, 3, 3)).to(torch.bfloat16)
            outs = [nan(batch, mid, HW) for _ in range(2)]
            for f, o in ((ig.jt_conv3x3_in, outs[0]), (ig._jt_conv3x3_in_plain, outs[1])):
                f(u[:batch], idx, cnt, (w3t, None), s2[:batch], "bf16", o)
            torch.cuda.synchronize()
            err = rel_max(*outs)
            log(f"kernel jt_conv3x3_in {label}, bf16: max_rel_err {err:.3e} (limit {tol:g})")
            if not (math.isfinite(err) and err <= tol):
                fails.append(("jt_conv3x3_in", label, "bf16", err))
            # fp_conv_in: two nets, each on its own kernel, slope and bias
            hs, es = r(2 * batch, c, H, H), r(2 * batch, c, H, H)
            w1s = (0.1 * r(2, mid, c, 3, 3)).to(torch.bfloat16)
            b1s, bn = 0.1 * r(2, mid), torch.tensor([1.1, 0.9], device=dev)
            for what, args in (("h1, swish", (hs, None, w1s, b1s, bn, "swish")),
                               ("th1, dswish", (es, hs, w1s, None, bn, "dswish"))):
                outs = [nan(2 * batch, mid, HW) for _ in range(2)]
                for f, o in ((ff.fp_conv_in, outs[0]), (ff._fp_conv_in_plain, outs[1])):
                    f(*args, "bf16", o)
                torch.cuda.synchronize()
                err = rel_max(*outs)
                log(f"kernel fp_conv_in {label}, bf16, 2 nets, {what}: max_rel_err {err:.3e} "
                    f"(limit {tol:g})")
                if not (math.isfinite(err) and err <= tol):
                    fails.append(("fp_conv_in", label, what, err))
            # rv_conv3x3_in: slot s reads example idx[s]
            w1b, bt = w1.to(torch.bfloat16), bn[:1]
            for what, args in (("h1, swish", (x, idx, cnt, (w1b, None), b1, 1.0, bt, "swish")),
                               ("t2, alpha -1", (u[:batch], idx, cnt, (w3t, None), None, -1.0,
                                                 None, "id"))):
                outs = [nan(batch, mid, HW) for _ in range(2)]
                for f, o in ((ig.rv_conv3x3_in, outs[0]), (ig._rv_conv3x3_in_plain, outs[1])):
                    f(*args, "bf16", o)
                torch.cuda.synchronize()
                err = rel_max(*outs)
                log(f"kernel rv_conv3x3_in {label}, bf16, {what}: max_rel_err {err:.3e} "
                    f"(limit {tol:g})")
                if not (math.isfinite(err) and err <= tol):
                    fails.append(("rv_conv3x3_in", label, what, err))
            # fp_conv_out: four "nets" of t on the two nets' kernels
            t4 = r(4 * batch, mid, HW).to(torch.bfloat16).float()
            outs = [nan(4 * batch, c * HW) for _ in range(2)]
            for f, o in ((ff.fp_conv_out, outs[0]), (ff._fp_conv_out_plain, outs[1])):
                f(t4, w1t, "bf16", o, H, H, nets=4)
            torch.cuda.synchronize()
            err = rel_max(*outs)
            log(f"kernel fp_conv_out {label}, bf16, 4 nets: max_rel_err {err:.3e} "
                f"(limit {tol:g})")
            if not (math.isfinite(err) and err <= tol):
                fails.append(("fp_conv_out", label, "bf16", err))
    assert not fails, ("phase 14, narrow widths (name, block, mode, error)", fails)


def check_block_functions(cap):
    """Phase 15: the whole merged forward vs its plain version per scale:
    in tf32 with the ladder at eps 1e-6 (the main path) and 1e-5, and in f32,
    max|dz| <= 5e-4, converged and protective-break flags equal, nstep
    within one where the tolerance lies above the split modes' floor (f32,
    and eps 1e-5: see phase 3), the accs by rel_norm over acc - eps at
    BLOCK_ACC_TOL with the control (the plain version in mode f32 against
    the tf32 one) above it. Each run also reads its sum-order floor, as
    phase 3: the plain forward with lin_conv1x1_mid, lin_conv3x3_in or both,
    or the solve's conv3x3_in or conv3x3_out, summed exactly, or
    conv3x3_out summed in its kernel's order (ops/sum_order.py) against the
    plain forward, by the same measures (no limit is held to them). Then the
    one-net chain (fused_neumann_chain, the row-2 kernels on one net) on net
    x's captured operands vs its plain
    version, with its device time, plain time and bound. Every reading is
    printed before the limits are checked."""
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_chain as fc
    from implicit_normalizing_flows_torch.ops import sum_order as so

    exact = dict(lin_conv1x1_mid=so.lin_conv1x1_mid_exact,
                 lin_conv3x3_in=so.lin_conv3x3_in_exact)
    floor_ops = {"lin_conv1x1_mid exact": dict(fb._PLAIN_OPS,
                                               lin_conv1x1_mid=exact["lin_conv1x1_mid"]),
                 "lin_conv3x3_in exact": dict(fb._PLAIN_OPS,
                                              lin_conv3x3_in=exact["lin_conv3x3_in"]),
                 "both exact": dict(fb._PLAIN_OPS, **exact),
                 "conv3x3_in exact": dict(fb._PLAIN_OPS, conv3x3_in=so.conv3x3_in_exact),
                 "conv3x3_out exact": dict(fb._PLAIN_OPS, conv3x3_out=so.conv3x3_out_exact),
                 "conv3x3_out in its kernel's order": dict(
                     fb._PLAIN_OPS, conv3x3_out=so.conv3x3_out_tiled)}
    full = dict(stall_guard=None, newton_init=False, warm_start=False, tail_mode=None,
                tail_start=None, line_search=False)
    fails = []
    for c, d in cap.items():
        args, kw0 = d["args"], d["kw"]
        eps_x, eps_z = args[3], args[4]
        accs = {}
        for mode, eps in (("tf32", 1e-6), ("tf32", 1e-5), ("f32", 1e-6)):
            kw = dict(kw0, mode=mode, eps=eps)
            if mode == "f32":
                kw.update(tail_mode=None, tail_start=None)
            with torch.no_grad():
                t0 = time.perf_counter()
                rk, *ak = fb.fused_block_forward(*args, **kw)
                torch.cuda.synchronize()
                tk = time.perf_counter() - t0
                t0 = time.perf_counter()
                rp, *ap = fb.fused_block_forward_plain(*args, **kw)
                torch.cuda.synchronize()
                tp = time.perf_counter() - t0
                floors = []
                for what, ops in floor_ops.items():
                    rx, *ax = fb._block_forward(ops, *args, **dict(full, **kw))
                    fdn = (rx.nstep - rp.nstep).abs().long()
                    ferr = max(rel_norm(a, b, e) for a, b, e in zip(ax, ap, (eps_x, eps_z)))
                    floors.append(
                        f"{what} vs plain: max|dz| "
                        f"{float((rx.result - rp.result).abs().max()):.3e} |d nstep| counts "
                        f"{torch.bincount(fdn).tolist()} converged flags differing "
                        f"{int((rx.converged != rp.converged).sum())} prot flags differing "
                        f"{int((rx.prot_break != rp.prot_break).sum())} accs rel_norm "
                        f"{ferr:.3e}")
                    del rx, ax
            accs[mode, eps] = ap
            dz = float((rk.result - rp.result).abs().max())
            dn = (rk.nstep - rp.nstep).abs().long()
            err = max(rel_norm(a, b, e) for a, b, e in zip(ak, ap, (eps_x, eps_z)))
            tol = BLOCK_ACC_TOL[mode]
            label = f"c{c} {mode} eps {eps:g}"
            log(f"merged forward {label}: max|dz| {dz:.3e} |d nstep| counts "
                f"{torch.bincount(dn).tolist()} nstep mean {rk.nstep.float().mean():.2f}/"
                f"{rp.nstep.float().mean():.2f} converged {rk.converged.float().mean():.3f}/"
                f"{rp.converged.float().mean():.3f} prot {int(rk.prot_break.sum())}/"
                f"{int(rp.prot_break.sum())} accs rel_norm {err:.3e} (limit {tol:g}) "
                f"s {tk:.3f}/{tp:.3f} (kernels/plain); sum-order floors (accs limit {tol:g}): "
                + "; ".join(floors))
            ok = (bool(torch.isfinite(rk.result).all()) and dz <= 5e-4
                  and torch.equal(rk.prot_break, rp.prot_break)
                  and torch.equal(rk.converged, rp.converged) and err <= tol
                  and all(bool(torch.isfinite(a).all()) for a in ak))
            if mode == "f32" or eps > 1e-6:
                ok = ok and int(dn.max()) <= 1
            if not ok:
                fails.append(("merged forward", label, dz, err))
        ctrl = min(rel_norm(a, b, e) for a, b, e in zip(accs["f32", 1e-6], accs["tf32", 1e-6],
                                                         (eps_x, eps_z)))
        log(f"merged forward c{c}: control (f32 against tf32 accs) {ctrl:.3e}, above "
            f"{BLOCK_ACC_TOL['tf32']:g}")
        if not ctrl > BLOCK_ACC_TOL["tf32"]:
            fails.append(("merged forward control", c, ctrl))

        # row 6: the one-net chain on net x's operands (bf16, the main path's
        # chain dtype), the captured n_power
        x, data_x, data_z, _, _, signed, n_power = args
        lin, _ = block_operands(d, "tf32")
        chain = fb.chains(data_x, data_z, eps_x, eps_z, lin, "tf32")[0]
        ak = fc.fused_neumann_chain(chain, signed, n_power)
        ap = fc.fused_neumann_chain_plain(chain, signed, n_power)
        err = rel_norm(ak, ap, eps_x)
        ms = device_ms(lambda i: fc.fused_neumann_chain(chain, signed, n_power), reps=3)
        pms = device_ms(lambda i: fc.fused_neumann_chain_plain(chain, signed, n_power), reps=3)
        B, _, H, W = x.shape
        mid = data_x["w2"].shape[0]
        # the function's inputs once (the probe and kernels in bf16, the s
        # factors float32), acc written once; every term's products
        bms, by = bound_ms(nbytes(*((t, 2) for t in (chain[0], *chain[4:])), *chain[1:4], ak),
                           n_power * B * H * W * mid * (18 * c + mid), "bf16")
        log(f"one-net chain c{c} bf16 n_power {n_power}: rel_norm {err:.3e} (limit "
            f"{CHAIN_TOL['bf16']:g}) ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by})")
        if not err <= CHAIN_TOL["bf16"]:
            fails.append(("one-net chain", c, err))
        del lin, chain, accs
    assert not fails, ("phase 15", fails)


# ---------------------------------------------------------------------------
# phases 11-13: the tabular POWER recipe on the generic solver

def build_tabular(dev):
    """The POWER recipe of run_tabular.sh at full width on the card, from a
    seeded init (the weights drawn on the CPU)."""
    from implicit_normalizing_flows_torch.models import build_tabular_model

    return build_tabular_model(TAB_DIM, dims="128-128-128-128", nblocks=20, act="sin",
                               coeff=0.99, vnorms="222222", n_lipschitz_iters=None,
                               atol=1e-3, rtol=1e-3, eps_forward=1e-5,
                               generator=torch.Generator().manual_seed(0), device=dev)


def tabular_batches():
    """(batch(i), the evaluation batch): batches of 1000 rows of the
    synthetic POWER stand-in's training split, epoch after epoch in a
    seeded order, and the first 4000 rows of its validation split."""
    import numpy as np

    from implicit_normalizing_flows_torch.data import batch_iterator, get_tabular_datasets

    train, valid, _ = get_tabular_datasets("power", os.path.join(HERE, "data"),
                                           synthetic_fallback=True)
    rng, batches = np.random.RandomState(0), []

    def batch(i):
        while len(batches) <= i:
            batches.extend(batch_iterator(train, TAB_BATCH, rng))
        return torch.from_numpy(batches[i])

    return batch, torch.from_numpy(valid[:TAB_EVAL_BATCH])


def tabular_steps(step, batch, draws, n0, n, every=1):
    """n training steps with per-step metrics and host-clock ms; logs every
    ``every``-th step and the last."""
    out = []
    for i in range(n0, n0 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch(i), draws(i))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        vals = {k: float(v) for k, v in m.items()}
        if (i - n0) % every == 0 or i == n0 + n - 1:
            log(f"tabular step {i}: loss {vals['loss']:.5f} logpz {vals['logpz']:.4f} "
                f"delta_logp {vals['delta_logp']:.4f} grad_norm {vals['grad_norm']:.4f} "
                f"nstep {vals['broyden_nstep']:.2f} "
                f"converged {vals['broyden_converged']:.3f} "
                f"rms_over_tol {vals['broyden_rms_over_tol']:.3f} "
                f"prot {vals['broyden_prot_break']:.0f} est_firmom {vals['est_firmom']:.4f} "
                f"ms {ms:.1f}")
        assert all(math.isfinite(v) for v in vals.values()), (i, vals)
        out.append((vals, ms))
    return out


def capture_tabular_inputs(step, batch, draws, eval_step, x_eval, eval_draws):
    """Every block's real solver inputs: its forward-solve input and its
    backward-solve (grad, z) from one training step's gradient, and its
    forward-solve input at the evaluation batch."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock

    fwd, bwd, ev = {}, {}, {}
    orig_solve, orig_bwd = ImplicitBlock.solve, ImplicitBlock.backward_solve
    seen = [fwd]

    def rec_solve(self, x, data_x=None, data_z=None):
        seen[0].setdefault(self, x.detach().clone())
        return orig_solve(self, x, data_x, data_z)

    def rec_bwd(self, grad, z):
        bwd.setdefault(self, (grad.detach().clone(), z.detach().clone()))
        return orig_bwd(self, grad, z)

    with patched([(ImplicitBlock, "solve", rec_solve),
                  (ImplicitBlock, "backward_solve", rec_bwd)]):
        step.grads(batch, draws)
        seen[0] = ev
        eval_step(x_eval, eval_draws)
    return [(b, fwd[b], bwd[b], ev[b]) for b in fwd]


def record_updates(run):
    """The inputs of every broyden_update call of run(), cloned before the
    call (it writes in place): [(Us, VTs, dx, dgx, gx, active, col)]."""
    from implicit_normalizing_flows_torch.ops import broyden as bmod

    calls, orig = [], bmod.broyden_update

    def rec(Us, VTs, dx, dgx, gx, active, col):
        calls.append(tuple(t.clone() for t in (Us, VTs, dx, dgx, gx, active)) + (col,))
        return orig(Us, VTs, dx, dgx, gx, active, col)

    with patched([(bmod, "broyden_update", rec)]):
        run()
    return calls


def synthetic_update_inputs(B, D, K, col, dev, seed):
    """Solver-scale factors with the columns >= col zero, a secant-like
    step, two inactive rows and one zero-denominator row (delta_gx = 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape, s=1.0: s * torch.randn(*shape, device=dev, generator=gen)
    Us, VTs = rnd(B, D, K, s=0.3 / D ** 0.5), rnd(B, K, D, s=0.3 / D ** 0.5)
    Us[:, :, col:] = 0.0
    VTs[:, col:, :] = 0.0
    dx = rnd(B, D)
    dgx = -dx + rnd(B, D, s=0.3)
    dgx[3] = 0.0
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[[1, 5]] = False
    return Us, VTs, dx, dgx, rnd(B, D), active


def check_update_kernel(inputs, dev):
    """Phase 11: broyden_update vs its plain version. Real inputs: every
    call of the forward solve (B 1000, K 30), backward solve (K 4) and
    evaluation solve (B 4000) of the block whose forward solve runs longest;
    a column past a solve's last is taken on the state of its last call,
    whose later columns are zero, as the solver leaves them. Synthetic
    inputs at BSDS300's width and a scrub case."""
    from implicit_normalizing_flows_torch.ops import broyden_update as bu

    fwd = [(record_updates(lambda: blk.solve(x)), blk, bwd_args, x_ev)
           for blk, x, bwd_args, x_ev in inputs]
    fwd_calls, blk, bwd_args, x_ev = max(fwd, key=lambda t: len(t[0]))
    log(f"phase 11 inputs: block {[b for b, *_ in inputs].index(blk)}, forward solve of "
        f"{len(fwd_calls)} iterations")
    cases = []
    for label, calls, K in (
            ("forward", fwd_calls, 30),
            ("backward", record_updates(lambda: blk.backward_solve(*bwd_args)), 4),
            ("eval", record_updates(lambda: blk.solve(x_ev)), 30)):
        for col in sorted({0, 3, K - 1}):
            real = max((c for c in calls if c[-1] <= col), key=lambda c: c[-1])
            cases.append((f"{label} (last real column {real[-1]})", real[:6], col))
    for col in (0, 3, 29):
        cases.append(("synthetic D 63, scrub rows",
                      synthetic_update_inputs(TAB_BATCH, 63, 30, col, dev, col), col))
    cases.append(("synthetic D 6, scrub rows",
                  synthetic_update_inputs(TAB_BATCH, TAB_DIM, 30, 3, dev, 99), 3))
    row, worst = None, 0.0
    for label, (Us, VTs, dx, dgx, gx, act), col in cases:
        B, D, K = Us.shape
        uk, vk, up, vp = Us.clone(), VTs.clone(), Us.clone(), VTs.clone()
        dk = bu.broyden_update(uk, vk, dx, dgx, gx, act, col)
        dp = bu.broyden_update_plain(up, vp, dx, dgx, gx, act, col)
        torch.cuda.synchronize()
        errs = [rel_max(uk, up), rel_max(vk, vp), rel_max(dk, dp)]
        # repeated calls rewrite the same column from the same inputs
        ms = device_ms(lambda i: bu.broyden_update(uk, vk, dx, dgx, gx, act, col))
        pms = device_ms(lambda i: bu.broyden_update_plain(up, vp, dx, dgx, gx, act, col))
        # live columns of U and V^T, three vectors and the mask read; a
        # column, a row and the update written
        nb = 4 * B * D * (2 * col + 6) + B
        bms, by = bound_ms(nb, 6 * B * D * max(col, 1), "f32")
        log(f"kernel broyden_update {label}: B {B} D {D} K {K} col {col}: max_rel_err "
            f"Us {errs[0]:.2e} VTs {errs[1]:.2e} update {errs[2]:.2e}, ms {ms:.4f} "
            f"plain_ms {pms:.4f} bound_ms {bms:.6f} ({by})")
        assert all(math.isfinite(e) and e <= UPDATE_TOL for e in errs), (label, col, errs)
        assert torch.isfinite(uk).all() and torch.isfinite(vk).all(), (label, col)
        worst = max(worst, *(float((a - b).abs().max())
                             for a, b in ((uk, up), (vk, vp), (dk, dp))))
        if label.startswith("forward") and col == 3:  # the main path's shape
            row = dict(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by)
    return {"broyden_update": {0: dict(row, max_abs_err=worst)}}


@contextlib.contextmanager
def bwd_precision(mode):
    """IMNF_BWD_PRECISION = mode for the duration (read at each call)."""
    old = os.environ.get("IMNF_BWD_PRECISION")
    os.environ["IMNF_BWD_PRECISION"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["IMNF_BWD_PRECISION"]
        else:
            os.environ["IMNF_BWD_PRECISION"] = old


def check_generic_solves(inputs):
    """Phase 12: every block's generic forward solve and backward solve (in
    bf16 and f32) with the kernel against the plain version: roots within
    max|d| 1e-5, equal converged and protective-break flags, iteration
    counts within one."""
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import broyden as bmod
    from implicit_normalizing_flows_torch.ops import broyden_update as bu

    last, orig = {}, implicit_block.root_solve

    def rec_root(*a, **k):
        out = orig(*a, **k)
        last["res"] = out[1]
        return out

    def both(run):
        with patched([(implicit_block, "root_solve", rec_root)]):
            rk = run()
            with patched([(bmod, "broyden_update", bu.broyden_update_plain)]):
                rp = run()
        torch.cuda.synchronize()
        return rk, rp

    def forward(blk, x):
        blk.solve(x)
        return last["res"]

    worst = {}
    for i, (blk, x, (grad, z), _) in enumerate(inputs):
        runs = [("forward", lambda: forward(blk, x))]
        for mode in ("bf16", "f32"):
            def bwd(mode=mode):
                with bwd_precision(mode):
                    return blk.backward_solve(grad, z)
            runs.append((f"backward {mode}", bwd))
        for label, run in runs:
            rk, rp = both(run)
            d = float((rk.result - rp.result).abs().max())
            rel = d / max(float(rp.result.abs().max()), 1e-30)
            dn = abs(int(rk.nstep) - int(rp.nstep))
            w = worst.setdefault(label, [0.0, 0.0, 0])
            w[:] = max(w[0], d), max(w[1], rel), max(w[2], dn)
            assert torch.isfinite(rk.result).all(), (i, label)
            assert torch.equal(rk.converged, rp.converged), (i, label)
            assert torch.equal(rk.prot_break, rp.prot_break), (i, label)
            assert d <= 1e-5 and dn <= 1, (i, label, d, dn)
            if i in (0, len(inputs) - 1):
                log(f"solve block {i} {label}: max|d root| {d:.3e} (rel {rel:.3e}) nstep "
                    f"{int(rk.nstep)}/{int(rp.nstep)} best_step differs at "
                    f"{int((rk.best_step != rp.best_step).sum())} examples, converged "
                    f"{rk.converged.float().mean():.3f}, prot {int(rk.prot_break.sum())} "
                    "(kernel/plain)")
    for label, (d, rel, dn) in worst.items():
        log(f"solves over {len(inputs)} blocks, {label}: max|d root| {d:.3e} "
            f"(rel {rel:.3e}), max |d nstep| {dn}")


def tabular_path(dev, rows):
    """Phases 11-13 on the POWER recipe; returns the broyden_update launch
    counts of the timed steps and of the evaluation batch, and the state it
    leaves (model, step, batch, draws, the next step's index)."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock
    from implicit_normalizing_flows_torch.ops import broyden as bmod
    from implicit_normalizing_flows_torch.ops import broyden_update as bu
    from implicit_normalizing_flows_torch.ops import logdet as ld
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import (adam, linear_warmup,
                                                           make_density_eval_step,
                                                           make_density_train_step)

    model = build_tabular(dev)
    # train_tabular.py's optimizer: Adam (0.9, 0.999), lr 1e-3 with 1000
    # warmup iterations, clip 1.0; adaptive power iteration; EMA 0.999
    optimizer = adam(linear_warmup(1e-3, 1000), grad_clip=1.0)
    step = make_density_train_step(model, optimizer, ema_decay=0.999, n_lipschitz_iters=None)
    eval_step = make_density_eval_step(model)
    batch, x_eval = tabular_batches()
    draws = lambda i: Draws(torch.Generator(device=dev).manual_seed(3000 + i))

    # phase 13, first part: the warm-up
    t0 = time.perf_counter()
    warm = tabular_steps(step, batch, draws, 0, TAB_WARMUP, every=20)
    last = warm[-10:]
    nstep = sum(v["broyden_nstep"] for v, _ in last) / len(last)
    log(f"tabular warm-up: {TAB_WARMUP} steps in {time.perf_counter() - t0:.1f} s, mean "
        f"forward nstep over the last 10 {nstep:.2f}")
    assert nstep > 2.0, nstep

    # phases 11 and 12 on this state (gradients only: the weights stay put)
    n = TAB_WARMUP
    inputs = capture_tabular_inputs(step, batch(n), draws(n), eval_step, x_eval, draws(n))
    rows.update(check_update_kernel(inputs, dev))
    check_generic_solves(inputs)
    del inputs

    # phase 13, the main path
    torch.cuda.reset_peak_memory_stats()
    tabular_steps(step, batch, draws, n, TAB_SETTLE)
    n += TAB_SETTLE
    reset_launch_counts()
    timed = tabular_steps(step, batch, draws, n, TAB_TIMED)
    launches = launch_counts()
    n += TAB_TIMED
    ms = sorted(t for _, t in timed)
    log("tabular path kernels " + json.dumps({k: launches[k] for k in bu.KERNELS}))
    log(f"tabular steps: timed ms {', '.join(f'{t:.1f}' for _, t in timed)} (median "
        f"{ms[len(ms) // 2]:.1f}), mean forward nstep "
        f"{sum(v['broyden_nstep'] for v, _ in timed) / len(timed):.2f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    assert launches["broyden_update"] > 0, launches
    parts = [(ImplicitBlock, "solve", "forward solves"),
             (ld, "basic_logdet_estimator", "estimators"),
             (ImplicitBlock, "backward_solve", "backward solves"),
             (ImplicitBlock, "reattach_vjp", "re-attachments"),
             (step.optimizer, "update", "update"), (type(model), "update_lipschitz", "update")]
    breakdown_step(step, batch(n), draws(n), parts,
                   "the rest (autograd, the estimators' second-order backward among it)")
    profile_train_step(step, batch(n + 1), draws(n + 1))
    plain = [(bmod, "broyden_update", bu.broyden_update_plain)]
    compare_plain_step(step, batch(n + 2), lambda: draws(n + 2), plain, dl_max=1e-4)

    # one evaluation batch of 4000: the brute-force log-det
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk = eval_step(x_eval, draws(n + 3))
    torch.cuda.synchronize()
    ems = 1e3 * (time.perf_counter() - t0)
    eval_launches = launch_counts()
    with patched(plain):
        mp = eval_step(x_eval, draws(n + 3))
    d = abs(float(mk["loss"]) - float(mp["loss"]))
    dvec = float((mk["nll_vec"] - mp["nll_vec"]).abs().max())
    log(f"tabular eval batch {TAB_EVAL_BATCH}: NLL {float(mk['loss']):.5f} (plain "
        f"{float(mp['loss']):.5f}, |d| {d:.2e}, max|d per row| {dvec:.2e}), nstep "
        f"{float(mk['broyden_nstep']):.2f} converged {float(mk['broyden_converged']):.3f} "
        f"ms {ems:.1f}, broyden_update launches {eval_launches['broyden_update']}")
    assert mk["nll_vec"].shape == (TAB_EVAL_BATCH,) and torch.isfinite(mk["nll_vec"]).all()
    assert mk["z"].shape == (TAB_EVAL_BATCH, TAB_DIM) and torch.isfinite(mk["z"]).all()
    assert d <= 1e-4, d
    assert eval_launches["broyden_update"] > 0, eval_launches
    return launches, eval_launches, (model, step, batch, draws, n + 4)


# ---------------------------------------------------------------------------
# phase 17: sampling (ImplicitFlow.inverse), the forward solve's kernels with
# the nets' roles swapped

SAMPLE_TAU = 0.8  # qualitative_samples.py's temperature
SAMPLE_BATCHES = 3
# Phase 17 holds the kernel path's images against the plain path's, max|dx|
# over pixels in [0, 1]; when the plain path's sum-order floor (the plain
# path with the solve's three products summed exactly) lies above it, the
# plain path is the faulty reference, and the exactly summed path takes its
# place at the same limit.
SAMPLE_TOL = 1e-3
NO_LADDER = dict(tail_mode=None, tail_start=None)  # _solve's keywords the blocks may omit


def sample_latents(model, seed, dev):
    """BATCH flat latents tau * N(0, 1) from a generator seeded on the card
    (``qualitative_samples.py:84-88``)."""
    dim = sum(math.prod(d) for d in model.dims)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return SAMPLE_TAU * torch.randn(BATCH, dim, generator=gen, device=dev)


def exact_solve(x, data_x, data_z, **kw):
    """The plain fused solve with its three products summed exactly
    (``ops/sum_order.py``)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import sum_order as so

    ops = dict(fs.solve_ops(plain=True), conv1x1_mid=so.conv1x1_mid_exact,
               conv3x3_in=so.conv3x3_in_exact, conv3x3_out=so.conv3x3_out_exact)
    return fs._solve(x, data_x, data_z, ops, **dict(NO_LADDER, **kw))[0]


STATE_STEP = 6  # phase 17 reads broyden_step on its input at this step of a solve


def record_step_state(z, data_a, data_b, kw):
    """The input of broyden_step's STATE_STEP-th step (or its last, if
    fewer) in the plain solve of z with ``data_a`` embedding and ``data_b``
    solved, mid-way through the inverse solves' 5-17 iterations: (phase,
    idx, cnt, state, keywords), cloned."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    seen = {"steps": 0}

    def rec(phase, idx_in, cnt_in, idx_out, cnt_out, st, **k):
        if phase == fs.PHASE_STEP and seen["steps"] < STATE_STEP:
            seen["steps"] += 1
            seen["snap"] = (phase, idx_in.clone(), cnt_in.clone(),
                            {n: v.clone() for n, v in st.items()}, k)
        return fs._broyden_step_plain(phase, idx_in, cnt_in, idx_out, cnt_out, st, **k)

    fs._solve(z, data_a, data_b, dict(fs._PLAIN, broyden_step=rec), **dict(NO_LADDER, **kw))
    return seen["snap"]


def capture_inverse_inputs(model, z):
    """Each scale's first implicit block (the last one the inverse reaches;
    scale 0's nets have no preact) with its input in one inverse of z with
    every plain version forced (plain_versions: the inverse solves through
    the same fused_broyden_solve), so that the inputs, and the floors read
    on them, do not move with the port's kernels; and each one's
    broyden_step input mid-way through its plain solve
    (:func:`record_step_state`). Returns (blocks, states)."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock

    blocks = [next(m for m in scale if isinstance(m, ImplicitBlock)) for scale in model.transforms]
    seen = {}

    def recorder(s, inverse):
        def run(zz, *a):
            seen[s] = zz.detach().clone()
            return inverse(zz, *a)
        return run

    for s, b in enumerate(blocks):
        b.inverse = recorder(s, b.inverse)
    try:
        with patched(plain_versions(False)):
            model.inverse(z)
    finally:
        for b in blocks:
            del b.inverse
    states = []
    with torch.no_grad():
        for s, b in enumerate(blocks):
            dx, dz = b._forward_data()
            states.append(record_step_state(seen[s], dz, dx,
                                            b._fused_solve_kwargs(b.solver_cfg.eps_sample)))
    return [(b, seen[s]) for s, b in enumerate(blocks)], states


@torch.no_grad()
def real_operand_controls(blocks):
    """Phase 17's controls on the inverse's real operands: each product of
    the solved net (net x) at the block's input z, every input the plain
    tf32 output of the stage before, in f32 and with native TF32 emulated
    (both operands rounded to 10 mantissa bits), against tf32 (printed, no
    limit: on real data the split sits within about 2^-16 of float32, below
    the sum order's noise, which is why the probe is scaled to these
    operands and held)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops.precision_probe import round_tf32

    for s, (block, z) in enumerate(blocks):
        d = block.nnet_x.conv_forward_data()
        betas = [float(v) for v in d["betas"].cpu()]
        a = fs.swish(z, betas[0]) if d["preact"] else z
        for k, (w, b, pad) in enumerate(((d["w1"], d["b1"], 1), (d["w2"], d["b2"], 0),
                                         (d["w3"], d["b3"], 1))):
            w = w.detach().float()
            ref = fs._mconv(a, fs.prep_weight(w, "tf32"), "tf32", pad)
            f32 = fs._mconv(a, fs.prep_weight(w, "f32"), "f32", pad)
            nat = fs._mconv(round_tf32(a.contiguous()), fs.prep_weight(round_tf32(w), "f32"),
                            "f32", pad)
            log(f"phase 17 controls scale{s} product {k + 1} (input max "
                f"{float(a.abs().max()):.3g}): f32 against tf32 {rel_err(f32, ref):.3e}, native "
                f"TF32 against tf32 {rel_err(nat, ref):.3e} (SPLIT_TOL {SPLIT_TOL:g})")
            if k < 2:
                a = fs.swish(ref + b.detach()[None, :, None, None], betas[k + 1])


def sample_path(model, dev):
    """Phase 17's end-to-end part: one warm-up, then SAMPLE_BATCHES batches
    of BATCH samples through ``ImplicitFlow.inverse`` (host clock around
    synchronised work, peak memory, each block's nstep, protective breaks
    and the Banach fallback's time) with the four kernels' launch counts
    over them (each > 0), a profiled batch (busy time, idle share and the
    tensor-core routes held), the round trip forward(inverse(z)) on the
    kernel and the plain paths, and the kernel path's images against the
    plain path's beside its floor (SAMPLE_TOL's comment). Returns the
    launch counts."""
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    blocks = model.implicit_blocks()[::-1]  # in the order the inverse solves them
    model.inverse(sample_latents(model, 100, dev))  # warm-up
    solves, banach = [], []
    solve, fpi = implicit_block.fused_broyden_solve, implicit_block.fixed_point_iteration

    def rec_solve(*a, **k):
        res = solve(*a, **k)
        solves.append((res.nstep, res.prot_break))
        return res

    def timed_fpi(g, y, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fpi(g, y, **k)
        torch.cuda.synchronize()
        banach.append(1e3 * (time.perf_counter() - t))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with patched([(implicit_block, "fused_broyden_solve", rec_solve),
                  (implicit_block, "fixed_point_iteration", timed_fpi)]):
        for i in range(SAMPLE_BATCHES):
            z = sample_latents(model, i, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, _ = model.inverse(z)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            assert x.shape == (BATCH, 3, SIZE, SIZE) and torch.isfinite(x).all()
            log(f"sample batch {i}: {ms:.1f} ms, {BATCH / ms * 1e3:.1f} samples/s, images in "
                f"[{float(x.min()):.4f}, {float(x.max()):.4f}]")
    launches = launch_counts()
    log(f"sampling peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("sampling path kernels " + json.dumps(launches))
    for j, block in enumerate(blocks):
        n = torch.cat([solves[k][0] for k in range(j, len(solves), len(blocks))]).float()
        prot = sum(int(solves[k][1].sum()) for k in range(j, len(solves), len(blocks)))
        log(f"sampling block {model.implicit_blocks().index(block)} (inverse solve {j + 1} of "
            f"{len(blocks)}): nstep mean {float(n.mean()):.2f} max {int(n.max())}, protective "
            f"breaks {prot}")
    log(f"sampling protective-break rows {sum(int(p.sum()) for _, p in solves)}, Banach "
        f"fallback calls {len(banach)} (each iterating the whole batch until its rows "
        f"settle), {sum(banach):.1f} ms")
    assert all(launches[n] > 0 for n in fs.KERNELS), launches

    z = sample_latents(model, 0, dev)
    profiled_routes(lambda: profile_batch(model, lambda *_: model.inverse(z), None, None,
                                          "solve_inverse", "sampling batch"),
                    ["conv1x1_mid", "conv3x3_in", "conv3x3_out", "broyden_step"],
                    "sampling batch")

    with torch.no_grad():
        xk, _ = model.inverse(z)
        zk, _ = model(xk)
        with patched(plain_versions(False)):
            xp, _ = model.inverse(z)
            zp, _ = model(xp)
        with patched([(implicit_block, "fused_broyden_solve", exact_solve)]):
            xe, _ = model.inverse(z)
    log(f"sampling round trip max|forward(inverse(z)) - z|: kernels "
        f"{float((zk - z).abs().max()):.3e}, plain {float((zp - z).abs().max()):.3e}")
    floor = float((xe - xp).abs().max())
    vs_plain, vs_exact = float((xk - xp).abs().max()), float((xk - xe).abs().max())
    ref, reading = (("plain", vs_plain) if floor <= SAMPLE_TOL else
                    ("exactly summed", vs_exact))
    log(f"sampling images, kernels against plain: max|dx| {vs_plain:.3e}; against the plain "
        f"path with the solve's products summed exactly: {vs_exact:.3e}; floor (that path "
        f"against plain) {floor:.3e}; held against the {ref} path at {SAMPLE_TOL:g}")
    assert math.isfinite(reading) and reading <= SAMPLE_TOL, (ref, reading)
    return launches



# ---------------------------------------------------------------------------
# phase 18: the Armijo line search (IMNF_LINE_SEARCH=1,
# csrc/line_search.cu) in the forward, inverse, merged and backward solves,
# and the generic solver's

TPU_SEARCH = "implicit_normalizing_flows_tpu/ops/fused_solve.py:610"
SEARCH_ONLY = ("line_search",)  # routes held only where the search runs
SEARCH_SETTLE, SEARCH_TIMED = 3, 3  # phase 18's --mem-eff False steps
SEARCH_NAN = ((3, 5, "nan"), (7, 9, "inf"))  # (example, element, value) of GN


def search_ops():
    """The plain fused solve's ops with the line search's sums exact or in
    its kernel's order (ops/sum_order.py): {label: ops}."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import sum_order as so

    plain = fs.solve_ops(plain=True)
    return {"search sums exact": dict(plain, line_search=so.line_search_exact),
            "search sums in the kernel's order": dict(plain, line_search=so.line_search_tiled)}


def tally_of(run):
    """(run()'s result, the line search's tally over it)."""
    from implicit_normalizing_flows_torch.ops import line_search as lsm

    lsm.reset_tally()
    out = run()
    torch.cuda.synchronize()
    return out, lsm.read_tally()


def fmt_tally(t):
    return (f"failed {t['failed']}: quadratic {t['quadratic']}, halved {t['halved']}, "
            f"full {t['full']}")


@torch.no_grad()
def check_search_solves(blocks, inv_blocks, cap):
    """Phase 18, whole solves with the search, kernels against plain, on the
    checkpoint's blocks: the forward (phase 2's inputs, eps 1e-6, tf32 with
    the ladder), the inverse (phase 17's, eps 1e-5) and the backward (phase
    5's, bf16), each with newton_init True and False. Every reading and
    its floors (the plain path with the search's sums exact, or in its
    kernel's order, against the plain path) is printed before any limit is
    checked; the limits are phase 3's (17's) and phase 6's, against the
    plain path, or against the exactly summed path where a floor lies
    above them. Also prints each solve's tally (examples that failed the
    test and took the quadratic, halved or full step), and asserts that the
    newton_init=False solves took a shortened step. Returns each scale's
    state of the search captured mid-solve (:func:`capture_search_state`)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops import sum_order as so

    def against(r, ref):
        dn = (r.nstep - ref.nstep).abs().long()
        return dict(dz=float((r.result - ref.result).abs().max()),
                    counts=torch.bincount(dn).tolist(), dn=int(dn.max()),
                    conv=int((r.converged != ref.converged).sum()),
                    prot=int((r.prot_break != ref.prot_break).sum()))

    def forward_fails(a, hold_nstep):
        return (a["prot"] or a["conv"] or not a["dz"] <= 5e-4
                or (hold_nstep and a["dn"] > 1))

    readings, states, shortened = [], [], 0
    for what, blks, inverse in (("forward", blocks, False), ("inverse", inv_blocks, True)):
        for s, (block, x) in enumerate(blks):
            dx, dz = block.nnet_x.conv_forward_data(), block.nnet_z.conv_forward_data()
            eps = block.solver_cfg.eps_sample if inverse else block.solver_cfg.eps_forward
            if inverse:
                dx, dz = dz, dx
            for newton in (True, False):
                kw = dict(block._fused_solve_kwargs(eps), newton_init=newton, line_search=True)
                t0 = time.perf_counter()
                rk, tk = tally_of(lambda: fs.fused_broyden_solve(x, dx, dz, **kw))
                sk = time.perf_counter() - t0
                rp, tp = tally_of(lambda: fs.fused_broyden_solve_plain(x, dx, dz, **kw))
                floors = {k: fs._solve(x, dx, dz, ops, **dict(NO_LADDER, **kw))[0]
                          for k, ops in search_ops().items()}
                a = against(rk, rp)
                fa = {k: against(r, rp) for k, r in floors.items()}
                hold_nstep = kw["mode"] == "f32" or eps > 1e-6  # phase 3's rule
                label = (f"{what} solve scale{s} {kw['mode']} eps {eps:g} newton_init "
                         f"{newton}")
                log(f"phase 18 {label}: max|dz| {a['dz']:.3e} |d nstep| counts {a['counts']} "
                    f"converged flags differing {a['conv']} prot {a['prot']}; nstep mean "
                    f"{rk.nstep.float().mean():.2f}/{rp.nstep.float().mean():.2f}; kernels "
                    f"{fmt_tally(tk)}; plain {fmt_tally(tp)}; s {sk:.3f}; floors: "
                    + "; ".join(f"{k} vs plain: max|dz| {f['dz']:.3e} |d nstep| counts "
                                f"{f['counts']} converged {f['conv']} prot {f['prot']}"
                                for k, f in fa.items()))
                if not newton:
                    shortened += tk["quadratic"] + tk["halved"]
                floor_over = any(forward_fails(f, hold_nstep) for f in fa.values())
                ref = floors["search sums exact"] if floor_over else rp
                held = against(rk, ref)
                readings.append((label, "exactly summed" if floor_over else "plain", held,
                                 bool(torch.isfinite(rk.result).all()) and
                                 not forward_fails(held, hold_nstep)))
                if not inverse and not newton:
                    states.append(capture_search_state(x, dx, dz, kw))
    for s, (c, d) in enumerate(cap.items()):
        grad = d["grad"]
        cd = d["block"].nnet_z.conv_chain_data(d["z"], torch.bfloat16)
        for newton in (True, False):
            kw = dict(threshold=4, eps=1e-10, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
                      newton_init=newton, line_search=True, mode="bf16")
            rk, tk = tally_of(lambda: ig.fused_backward_solve(grad, cd, **kw))
            rp, tp = tally_of(lambda: ig.fused_backward_solve_plain(grad, cd, **kw))
            fl = {k: ig._backward_solve(grad, cd, dict(ig._PLAIN, line_search=fn), **kw).u
                  for k, fn in (("search sums exact", so.line_search_exact),
                                ("search sums in the kernel's order", so.line_search_tiled))}
            err = rel_norm(rk.u, rp.u, grad)
            ferr = {k: rel_norm(u, rp.u, grad) for k, u in fl.items()}
            label = f"backward solve scale{s} bf16 newton_init {newton}"
            log(f"phase 18 {label}: rel_norm {err:.3e} (limit {BWD_TOL['bf16']:g}); nstep "
                f"{rk.nstep.float().mean():.2f}/{rp.nstep.float().mean():.2f} prot "
                f"{int(rk.prot_break.sum())}/{int(rp.prot_break.sum())}; kernels "
                f"{fmt_tally(tk)}; plain {fmt_tally(tp)}; floors: "
                + "; ".join(f"{k} vs plain {v:.3e}" for k, v in ferr.items()))
            if not newton:
                shortened += tk["quadratic"] + tk["halved"]
            floor_over = any(v > BWD_TOL["bf16"] for v in ferr.values())
            held = rel_norm(rk.u, fl["search sums exact"] if floor_over else rp.u, grad)
            ok = (bool(torch.isfinite(rk.u).all()) and held <= BWD_TOL["bf16"]
                  and torch.equal(rk.nstep, rp.nstep)
                  and torch.equal(rk.prot_break, rp.prot_break))
            readings.append((label, "exactly summed" if floor_over else "plain", held, ok))
    log(f"phase 18: shortened steps (quadratic + halved) of the newton_init=False solves "
        f"{shortened}")
    fails = [r for r in readings if not r[3]]
    assert not fails, ("phase 18 (solve, held against, reading, ok)", fails)
    assert shortened > 0, "no newton_init=False solve took a shortened step"
    return states


def capture_search_state(x, dx, dz, kw):
    """The search's inputs at the iteration of the plain solve that took the
    most shortened steps (the first failing one if none did): the solver
    vectors and active list at its test, the quadratic and halved trials'
    residuals as the solve evaluated them, cloned: (st, idx, cnt, GQ, GH)."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import line_search as lsm

    best, cur = {"score": -1}, {}
    keys = ("Z", "G", "UPD", "ZN", "GN")

    def rec(phase, st, ls, idx=None, cnt=None):
        if phase == lsm.PHASE_TEST:
            cur.clear()
            cur.update(st={k: st[k].clone() for k in keys}, idx=idx.clone(), cnt=cnt.clone(),
                       before=ls["tally"].clone())
        elif phase == lsm.PHASE_HALF:
            cur["GQ"] = ls["GQ"].clone()
        else:
            cur["GH"] = ls["GH"].clone()
        lsm._line_search_plain(phase, st, ls, idx, cnt)
        if phase == lsm.PHASE_PICK:
            d = (ls["tally"] - cur["before"]).tolist()
            score = d[1] + d[2] if d[0] else -1
            if score > best["score"] or "st" not in best:
                best.update(score=score, **{k: v for k, v in cur.items() if k != "before"})

    fs._solve(x, dx, dz, dict(fs.solve_ops(plain=True), line_search=rec),
              **dict(NO_LADDER, **kw))
    return best["st"], best["idx"], best["cnt"], best["GQ"], best["GH"]


def search_bytes(D, n, nf, nq, nh, nok):
    """The bytes each step of the search must move (float32): the test reads
    G and GN of the n live examples and Z and UPD of the nf failing ones,
    writes their ZQ; the quadratic pick reads GQ of the nf, ZQ of the nq
    taking it and writes their ZN and GN, reads Z and UPD of the nh others
    and writes their ZH; the halved pick reads GH of the nh, ZH of the nok
    taking it and writes their ZN and GN."""
    return {"test": 4 * D * (2 * n + 3 * nf), "half": 4 * D * (nf + 3 * nq + 3 * nh),
            "pick": 4 * D * (nh + 3 * nok)}


def check_search_kernel(states):
    """Phase 18: line_search against its plain version and against the plain
    version in its kernel's order (ops/sum_order.py line_search_tiled) on
    each scale's captured state, on every slot and on half the slots under
    a permuted list, and on the state with NaN and inf residuals injected
    (SEARCH_NAN; a NaN in a quadratic residual): the three steps in turn
    (the captured trial residuals taken as the solve evaluated them). Held:
    the fail and half lists (sorted), their counts and the tally equal to
    both; every output bitwise equal to the kernel's order; the values
    (lsf's sq, ZQ, ZH, ZN, GN) within SPLIT_TOL of the plain version's;
    the examples off the list bitwise untouched. Each step timed on every
    slot (device time, plain time, bound). Returns the kernels row (the
    test step at 32x32)."""
    from implicit_normalizing_flows_torch.ops import line_search as lsm
    from implicit_normalizing_flows_torch.ops import sum_order as so

    same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())

    def finite_err(a, b):
        """rel_err over the entries finite in both; inf where the non-finite
        entries differ in place."""
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            return math.inf
        return rel_err(torch.where(fa, a, 0.0), torch.where(fb, b, 0.0))

    impls = {"kernel": lsm.line_search, "plain": lsm._line_search_plain,
             "kernel's order": so.line_search_tiled}
    outs_of = ("ZQ", "ZH", "lsf")
    fails, rows = [], {}

    def replay(fn, st0, idx, cnt, GQ, GH):
        B, D = st0["Z"].shape
        st = {k: v.clone() for k, v in st0.items()}
        ls = lsm.line_search_buffers(B, D, st0["Z"].device)
        lsm.reset_tally()
        fn(lsm.PHASE_TEST, st, ls, idx, cnt)
        ls["GQ"].copy_(GQ)
        fn(lsm.PHASE_HALF, st, ls)
        ls["GH"].copy_(GH)
        fn(lsm.PHASE_PICK, st, ls)
        torch.cuda.synchronize()
        lists = [sorted(ls[k][:int(ls["n" + k])].tolist()) for k in ("fail", "half")]
        return st, ls, lists, lsm.read_tally()

    for s, (st0, idx0, cnt0, GQ, GH) in enumerate(states):
        B, D = st0["Z"].shape
        dev = st0["Z"].device
        gen = torch.Generator(device=dev).manual_seed(180 + s)
        nan_st = {k: v.clone() for k, v in st0.items()}
        for e, j, v in SEARCH_NAN:
            nan_st["GN"][e, j] = float(v)
        nan_gq = GQ.clone()
        cases = {"captured, every slot": (st0, torch.arange(B, dtype=torch.int32, device=dev),
                                          GQ),
                 "captured, half the slots permuted": (
                     st0, torch.randperm(B, generator=gen, device=dev)[:B // 2].int(), GQ),
                 "NaN / inf residuals, every slot": (
                     nan_st, torch.arange(B, dtype=torch.int32, device=dev), nan_gq)}
        for which, (sti, idx, gq) in cases.items():
            cnt = torch.full((1,), len(idx), dtype=torch.int32, device=dev)
            got = {k: replay(fn, sti, idx, cnt, gq, GH) for k, fn in impls.items()}
            if which.startswith("NaN"):  # a NaN in a failing example's quadratic residual
                fail = got["plain"][2][0]
                if fail:
                    nan_gq[fail[0], 0] = float("nan")
                    got = {k: replay(fn, sti, idx, cnt, nan_gq, GH) for k, fn in impls.items()}
            (stk, lk, listk, tk) = got["kernel"]
            off = torch.ones(B, dtype=torch.bool, device=dev)
            off[idx.long()] = False
            untouched = all(torch.equal(stk[k][off], sti[k][off]) for k in stk) and all(
                not bool(lk[k][off].any()) for k in outs_of)
            line = []
            ok = untouched
            for ref in ("plain", "kernel's order"):
                stp, lp, listp, tp = got[ref]
                lists_eq = listk == listp and tk == tp
                bitwise = all(same(stk[k], stp[k]) for k in ("ZN", "GN")) and all(
                    same(lk[k], lp[k]) for k in outs_of)
                err = max(finite_err(a, b) for a, b in (
                    (stk["ZN"], stp["ZN"]), (stk["GN"], stp["GN"]), (lk["ZQ"], lp["ZQ"]),
                    (lk["ZH"], lp["ZH"]), (lk["lsf"][:, 1], lp["lsf"][:, 1])))
                line.append(f"against {ref}: lists, counts and tally equal {lists_eq}, bitwise "
                            f"{bitwise}, max_rel_err {err:.3e}")
                ok = ok and lists_eq and (bitwise if ref == "kernel's order"
                                          else math.isfinite(err) and err <= SPLIT_TOL)
            log(f"line_search scale{s} (B={B}, D={D}) {which}: {fmt_tally(tk)}, lists "
                f"{[len(v) for v in listk]}; " + "; ".join(line)
                + f"; other examples untouched {untouched}")
            if not ok:
                fails.append((s, which))

        # each step timed on every slot, on the captured state
        idx = torch.arange(B, dtype=torch.int32, device=dev)
        cnt = torch.full((1,), B, dtype=torch.int32, device=dev)
        st, ls, (fl, hl), t = replay(impls["plain"], st0, idx, cnt, GQ, GH)
        n = int(cnt.item())
        nbytes = search_bytes(D, n, len(fl), t["quadratic"], len(hl), t["halved"])
        times = {}
        for tag in ("kernel", "plain"):
            fn = impls[tag]
            st = {k: v.clone() for k, v in st0.items()}
            ls = lsm.line_search_buffers(B, D, dev)
            # the test leaves the solver state as it found it
            times[tag, "test"] = device_ms(lambda i: fn(lsm.PHASE_TEST, st, ls, idx, cnt))
            ls["GQ"].copy_(GQ)
            # the quadratic pick halves lsf's step and appends to the half
            # list: a fresh copy of both a call (its picks write the same
            # values each time)
            copies = iter([dict(ls, lsf=ls["lsf"].clone(), counts=c, nfail=c[0:1],
                                nhalf=c[1:2].zero_(), half=ls["half"].clone())
                           for c in (ls["counts"].clone() for _ in range(41))])
            times[tag, "half"] = device_ms(lambda i: fn(lsm.PHASE_HALF, st, next(copies)))
            del copies
            fn(lsm.PHASE_HALF, st, ls)
            ls["GH"].copy_(GH)
            times[tag, "pick"] = device_ms(lambda i: fn(lsm.PHASE_PICK, st, ls))
        for step in ("test", "half", "pick"):
            bms, by = bound_ms(nbytes[step], 0, "f32")
            ms, pms = times["kernel", step], times["plain", step]
            log(f"kernel line_search scale{s} (B={B}, D={D}) {step} step ({n} live, "
                f"{len(fl)} failed, {len(hl)} halved trials): ms {ms:.4f} plain_ms {pms:.4f} "
                f"bound_ms {bms:.6f} ({by}) share {bms / ms:.3f}")
        if s == 0:
            (stk, lk, _, _), (stp, lp, _, _) = (replay(impls[k], st0, idx, cnt, GQ, GH)
                                                for k in ("kernel", "plain"))
            bms, by = bound_ms(nbytes["test"], 0, "f32")
            rows["line_search"] = {0: dict(
                max_abs_err=max(float((a - b).abs().max()) for a, b in (
                    (stk["ZN"], stp["ZN"]), (stk["GN"], stp["GN"]), (lk["ZQ"], lp["ZQ"]),
                    (lk["ZH"], lp["ZH"]))),
                ms=times["kernel", "test"], plain_ms=times["plain", "test"], library_ms=None,
                bound_ms=bms, bound_by=by)}
    assert not fails, ("phase 18 line_search (scale, case)", fails)
    return rows


@contextlib.contextmanager
def searching(models=()):
    """IMNF_LINE_SEARCH=1 for the duration, with the implicit blocks of
    ``models`` (built before it) taking it from the environment too."""
    import dataclasses

    from implicit_normalizing_flows_torch.config import kernel_config

    with environ(IMNF_LINE_SEARCH="1"):
        blocks = [b for m in models for b in m.implicit_blocks()]
        with patched([(b, "solver_cfg", dataclasses.replace(
                b.solver_cfg, line_search=kernel_config().line_search)) for b in blocks]):
            yield



def search_eval_sample(model, eval_step, x_u8, draws, dev):
    """Phase 18's eval batch and sampling batch under the search, from the
    checkpoint: each timed (host clock around synchronised work) with the
    launch counts over it (every forward-solve kernel and line_search > 0)
    and the search's tally, a profiled run (idle share; the routes of the
    solve's kernels and the search's held), and the plain path on the same
    draws: |d mean bpd| <= 1e-3; the images within SAMPLE_TOL of the plain
    path's (or of the exactly summed path's where its floor lies above).
    Returns the two runs' launch counts."""
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    solve_routes = ["conv1x1_mid", "conv3x3_in", "conv3x3_out", "broyden_step", "line_search"]
    runs = {}
    for label in ("eval batch", "sampling batch"):
        z = sample_latents(model, 0, dev)
        run = ((lambda: eval_step(x_u8, draws(0))) if label == "eval batch"
               else (lambda: model.inverse(z)))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, tk = tally_of(run)
        ms = 1e3 * (time.perf_counter() - t0)
        runs[label] = launch_counts()
        log(f"phase 18 {label} (line search): {ms:.1f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {fmt_tally(tk)}; kernels "
            + json.dumps(runs[label]))
        assert all(runs[label][n] > 0 for n in list(fs.KERNELS) + ["line_search"]), runs[label]
        if label == "eval batch":
            profiled_routes(lambda: profile_batch(model, eval_step, x_u8, draws(0),
                                                  label="eval batch, line search"),
                            solve_routes, "eval batch, line search")
            with patched(plain_versions(False)):
                mp = eval_step(x_u8, draws(0))
            dbpd = abs(float(mp["bpd"]) - float(out["bpd"]))
            log(f"phase 18 eval batch: bpd {float(out['bpd']):.5f}, plain {float(mp['bpd']):.5f}, "
                f"|d mean bpd| {dbpd:.2e}, nstep {float(out['broyden_nstep']):.2f}, converged "
                f"{float(out['broyden_converged']):.3f}")
            assert torch.isfinite(out["bpd_vec"]).all() and 1.0 < float(out["bpd"]) < 8.0
            assert dbpd <= 1e-3, dbpd
            continue
        xk, _ = out
        assert xk.shape == (BATCH, 3, SIZE, SIZE) and torch.isfinite(xk).all()
        profiled_routes(lambda: profile_batch(model, lambda *_: model.inverse(z), None, None,
                                              "solve_inverse", "sampling batch, line search"),
                        solve_routes, "sampling batch, line search")
        with torch.no_grad():
            with patched(plain_versions(False)):
                xp, _ = model.inverse(z)
            with patched([(implicit_block, "fused_broyden_solve", exact_solve)]):
                xe, _ = model.inverse(z)
        floor = float((xe - xp).abs().max())
        vs_plain, vs_exact = float((xk - xp).abs().max()), float((xk - xe).abs().max())
        ref, reading = (("plain", vs_plain) if floor <= SAMPLE_TOL else
                        ("exactly summed", vs_exact))
        log(f"phase 18 sampling images, kernels against plain: max|dx| {vs_plain:.3e}; against "
            f"the exactly summed path {vs_exact:.3e}; floor {floor:.3e}; held against the {ref} "
            f"path at {SAMPLE_TOL:g}")
        assert math.isfinite(reading) and reading <= SAMPLE_TOL, (ref, reading)
    return runs["eval batch"], runs["sampling batch"]


def search_tabular(tab):
    """Phase 18's tabular steps: 3 steps of the POWER recipe from the state
    phase 13 leaves with the generic solver's search (ops/broyden.py, plain
    PyTorch around the rank-1 update kernel): host-clock ms, peak memory,
    the update kernel's launches (> 0), a profiled step (idle share) and one
    step with the plain update against the kernel's (|d loss| <= 1e-4)."""
    from implicit_normalizing_flows_torch.ops import broyden as bmod
    from implicit_normalizing_flows_torch.ops import broyden_update as bu

    model, step, batch, draws, n = tab
    with searching([model]):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timed = tabular_steps(step, batch, draws, n, SEARCH_TIMED)
        launches = launch_counts()
        log(f"phase 18 tabular steps (line search): ms "
            f"{', '.join(f'{t:.1f}' for _, t in timed)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, broyden_update launches "
            f"{launches['broyden_update']}")
        assert launches["broyden_update"] > 0, launches
        n += SEARCH_TIMED
        profile_train_step(step, batch(n), draws(n))
        compare_plain_step(step, batch(n + 1), lambda: draws(n + 1),
                           [(bmod, "broyden_update", bu.broyden_update_plain)], dl_max=1e-4)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from implicit_normalizing_flows_torch.data import synthetic_structured
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import broyden_update as bu
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops import fused_block as fb
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops import implicit_grad as ig
    from implicit_normalizing_flows_torch.ops import line_search as lsm
    from implicit_normalizing_flows_torch.ops.broyden import triage_metrics
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import (adam, linear_warmup,
                                                           make_image_eval_step,
                                                           make_image_train_step)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 1: build, one nvcc per source, in parallel
    t_start = t0 = time.perf_counter()
    built = cuda_build.build_all(list(SOURCES), report=True)
    log(f"phase1 build: {time.perf_counter() - t0:.1f} s -> "
        + ", ".join(os.path.relpath(p, HERE) for p in built.values()))

    model = build_model(dev)
    eval_step = make_image_eval_step(model, imagesize=SIZE)
    # a host tensor, as a user hands it over: the steps move it to the card
    x_u8 = torch.from_numpy(synthetic_structured(BATCH, 3, SIZE, SIZE, seed=1))
    draws = lambda i: Draws(torch.Generator(device=dev).manual_seed(1000 + i))
    # the benchmark's optimizer, schedule and EMA (bench.py:95-99)
    optimizer = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
    step = make_image_train_step(model, optimizer, ema_decay=0.999,
                                 n_lipschitz_iters=None, imagesize=SIZE)
    tdraws = lambda i: Draws(torch.Generator(device=dev).manual_seed(2000 + i))

    check_bf16_double_backward(dev)

    # phase 2: forward-solve kernels vs plain at each scale's real inputs
    blocks = capture_block_inputs(model, eval_step, x_u8, draws(99))
    rows = check_kernels(blocks)
    # phase 3: whole forward solves
    check_solves(blocks)

    # phase 4: the evaluation path
    reset_launch_counts()
    bpds, bpd0 = [], None
    for i in range(EVAL_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eval_step(x_u8, draws(i))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        bpd_vec = m["bpd_vec"]
        assert bpd_vec.shape == (BATCH,) and torch.isfinite(bpd_vec).all()
        assert m["z"].shape == (BATCH, 3 * SIZE * SIZE) and torch.isfinite(m["z"]).all()
        bpds.append(float(m["bpd"]))
        bpd0 = bpd_vec if bpd0 is None else bpd0
        log(f"eval batch {i}: bpd {bpds[-1]:.5f} nstep {float(m['broyden_nstep']):.2f} "
            f"converged {float(m['broyden_converged']):.3f} "
            f"conv3eps {float(m['broyden_converged_3eps']):.3f} "
            f"rms_over_tol {float(m['broyden_rms_over_tol']):.3f} "
            f"prot {float(m['broyden_prot_break']):.0f} ms {ms:.1f}")
        warn = triage_metrics(m)
        if warn:
            log(warn)
    eval_launches = launch_counts()
    log("eval path kernels " + json.dumps(eval_launches))
    assert all(eval_launches[n] > 0 for n in fs.KERNELS), eval_launches

    # the eval profile, with the split-mode routes of the solve's conv kernels
    profiled_routes(lambda: profile_batch(model, eval_step, x_u8, draws(0)),
                    ["conv1x1_mid", "conv3x3_in", "conv3x3_out", "broyden_step"], "eval batch")

    # the plain path on batch 0's draws
    implicit_block.fused_broyden_solve = fs.fused_broyden_solve_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp = eval_step(x_u8, draws(0))
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
    finally:
        implicit_block.fused_broyden_solve = fs.fused_broyden_solve
    dbpd = abs(float(mp["bpd"]) - bpds[0])
    log(f"plain path batch 0: bpd {float(mp['bpd']):.5f} |d mean bpd| {dbpd:.2e} "
        f"max|d bpd_vec| {float((mp['bpd_vec'] - bpd0).abs().max()):.2e} ms {pms:.1f}")
    assert dbpd <= 1e-3, dbpd
    assert 1.0 < bpds[0] < 8.0, bpds

    # phase 17: sampling (ImplicitFlow.inverse) on the eval model, before
    # training moves its weights: the kernels and whole solves on the
    # inverse's real operands, then the path end to end
    t17 = time.perf_counter()
    inv_blocks, inv_states = capture_inverse_inputs(model, sample_latents(model, 99, dev))
    check_kernels(inv_blocks, net="nnet_x", extra=("tf32x", "f32"), states=inv_states,
                  probe_range=True, phase="phase 17")
    real_operand_controls(inv_blocks)
    check_solves(inv_blocks, solve_configs(1e-5), inverse=True, phase="phase 17")
    del inv_states
    sample_launches = sample_path(model, dev)
    log(f"phase 17 {time.perf_counter() - t17:.1f} s")

    # phases 5 and 6: the implicit-gradient kernels and functions on one
    # training step's real inputs (gradients only: the weights stay put)
    cap = capture_grad_inputs(step, x_u8, tdraws(99))
    rows.update(check_grad_kernels(cap))
    check_grad_functions(cap)

    # phase 18, first part: the line search's whole solves and kernel on the
    # checkpoint's blocks (phases 2, 17 and 5's inputs), before training
    # moves the weights
    t18 = time.perf_counter()
    rows.update(check_search_kernel(check_search_solves(blocks, inv_blocks, cap)))
    t18 = time.perf_counter() - t18

    def train_path(model, step, estimator, label, merged=False, n_settle=SETTLE_STEPS,
                   n_timed=TIMED_STEPS, search=False):
        """``n_settle`` and ``n_timed`` steps with the launch counts over them, a
        breakdown, a profiled step and the plain comparison (with
        ``search``, the line search's route held and its tally printed);
        returns the launch counts and the timed steps' median ms."""
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        settle = train_steps(step, x_u8, tdraws, 0, n_settle)
        lsm.reset_tally()
        timed = train_steps(step, x_u8, tdraws, n_settle, n_timed)
        launches = launch_counts()
        log(f"train path ({label}) kernels " + json.dumps(launches))
        if search:
            log(f"train path ({label}) line search over the timed steps: "
                + fmt_tally(lsm.read_tally()))
        ms = sorted(t for _, t in timed)
        log(f"train steps ({label}): settle bpd {settle[-1][0]['bpd']:.5f}, timed ms "
            f"{', '.join(f'{t:.1f}' for _, t in timed)} (median {ms[len(ms) // 2]:.1f}), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        n = n_settle + n_timed
        breakdown_step(step, x_u8, tdraws(n), train_parts(model, step, estimator, merged),
                       "the rest" if estimator else "estimator and the rest")
        # a record holds a launch that ran and never one that did not, so
        # one profiled step with every count exact shows the routes; a step
        # whose record lost launches is profiled again, up to ROUTE_ATTEMPTS
        profiled_routes(lambda: profile_train_step(step, x_u8, tdraws(n + 1)),
                        [k for k in ROUTES if (estimator or k not in ESTIMATOR_ONLY)
                         and (merged or k not in MERGED_ONLY)
                         and (search or k not in SEARCH_ONLY)], f"{label} step")
        compare_plain_step(step, x_u8, lambda: tdraws(n + 2),
                           plain_versions(estimator, merged))
        return launches, ms[len(ms) // 2]

    # phase 7: the --mem-eff True training path
    memeff_launches, _ = train_path(model, step, False, "--mem-eff True")
    assert all(memeff_launches[n] > 0 for n in list(fs.KERNELS) + list(ig.KERNELS)), \
        memeff_launches

    # phases 8 and 9: the estimator kernels and functions of --mem-eff False
    # on one training step's real inputs (gradients only)
    model_d = build_model(dev, grad_in_forward=False)
    optimizer_d = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
    step_d = make_image_train_step(model_d, optimizer_d, ema_decay=0.999,
                                   n_lipschitz_iters=None, imagesize=SIZE)
    ecap = capture_estimator_inputs(step_d, x_u8, tdraws(98))
    rows.update(check_estimator_kernels(ecap))
    check_estimator_functions(ecap)
    del ecap

    # phase 10, the main path: training at the users' default --mem-eff False
    launches, split_ms = train_path(model_d, step_d, True, "--mem-eff False")
    conv_kernels = [n for _, m, _ in kernel_modules() if m not in (bu, fb, lsm)
                    for n in m.KERNELS]
    assert all(launches[n] > 0 for n in conv_kernels), launches
    del model_d, step_d
    t_conv = time.perf_counter() - t_start

    # phases 14 and 15: the merged forward's kernels and whole functions on
    # one merged training step's real inputs (gradients only)
    model_m = build_model(dev, grad_in_forward=False)
    optimizer_m = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
    step_m = make_image_train_step(model_m, optimizer_m, ema_decay=0.999,
                                   n_lipschitz_iters=None, imagesize=SIZE)
    bcap = capture_block_forward_inputs(step_m, x_u8, tdraws(97))
    rows.update(check_block_kernels(bcap))
    check_conv3x3_in_widths(dev)
    check_block_functions(bcap)
    del bcap

    # phase 16, the merged path: IMNF_FUSED_BLOCK=1 from the checkpoint
    with environ(IMNF_FUSED_BLOCK="1"):
        merged_launches, merged_ms = train_path(model_m, step_m, True, "IMNF_FUSED_BLOCK=1",
                                                merged=True)
    log(f"merged path median {merged_ms:.1f} ms; split path (phase 10) median {split_ms:.1f} ms")
    assert all(merged_launches[n] > 0 for n in conv_kernels + list(fb.KERNELS)), \
        merged_launches
    # two linearisations (net x, net z) per merged block and step: the four
    # 32x32 and 16x16 blocks merged, the two 8x8 ones split
    merged_blocks = merged_launches["lin_conv3x3_in"] / (2 * (SETTLE_STEPS + TIMED_STEPS))
    log(f"merged blocks per step: {merged_blocks:g}")
    assert merged_blocks == 4, merged_blocks
    del model_m, step_m
    t_merged = time.perf_counter() - t_start - t_conv

    # phases 11-13: the tabular POWER recipe on the generic solver
    tab_launches, tab_eval_launches, tab = tabular_path(dev, rows)
    t_tab = time.perf_counter() - t_start - t_conv - t_merged
    log(f"phases 1-10 {t_conv:.1f} s, phases 14-16 {t_merged:.1f} s, phases 11-13 "
        f"{t_tab:.1f} s")

    # phase 18, second part: the paths end to end with IMNF_LINE_SEARCH=1,
    # each against its plain path on the same draws
    t0 = time.perf_counter()
    with searching():
        model_s = build_model(dev)
        search_eval_launches, search_sample_launches = search_eval_sample(
            model_s, make_image_eval_step(model_s, imagesize=SIZE), x_u8, draws, dev)
        model_s = build_model(dev, grad_in_forward=False)
        optimizer_s = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
        step_s = make_image_train_step(model_s, optimizer_s, ema_decay=0.999,
                                       n_lipschitz_iters=None, imagesize=SIZE)
        search_launches, _ = train_path(model_s, step_s, True, "--mem-eff False, line search",
                                        n_settle=SEARCH_SETTLE, n_timed=SEARCH_TIMED,
                                        search=True)
        assert all(search_launches[n] > 0 for n in conv_kernels + ["line_search"]), \
            search_launches
        model_s = build_model(dev, grad_in_forward=False)
        optimizer_s = adam(linear_warmup(1e-3, 1000), betas=(0.9, 0.99), grad_clip=1.0)
        step_s = make_image_train_step(model_s, optimizer_s, ema_decay=0.999,
                                       n_lipschitz_iters=None, imagesize=SIZE)
        with environ(IMNF_FUSED_BLOCK="1"):
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            lsm.reset_tally()
            train_steps(step_s, x_u8, tdraws, 0, 1)
            merged_search_launches = launch_counts()
            log("phase 18 merged step (IMNF_FUSED_BLOCK=1, line search): peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                f"{fmt_tally(lsm.read_tally())}; kernels " + json.dumps(merged_search_launches))
            assert all(merged_search_launches[n] > 0
                       for n in conv_kernels + list(fb.KERNELS) + ["line_search"]), \
                merged_search_launches
            profile_train_step(step_s, x_u8, tdraws(1))
            compare_plain_step(step_s, x_u8, lambda: tdraws(2), plain_versions(True, merged=True))
        del model_s, step_s, optimizer_s
    search_tab_launches = search_tabular(tab)
    del tab
    t18 += time.perf_counter() - t0
    log(f"phase 18 {t18:.1f} s (tabular steps' update launches "
        f"{search_tab_launches['broyden_update']})")

    kernels = []
    for lib, mod, tpu in kernel_modules():
        for name in mod.KERNELS:
            path = (tab_launches if mod is bu else merged_launches if mod is fb
                    else search_launches if mod is lsm else launches)
            row = dict(name=name, route="cuda", source=SOURCES[lib], replaces=tpu(name),
                       launches=path[name], **rows[name][0])
            if name in TC_ROUTES:  # mode bf16 on the tensor cores
                row.update(source=TC_ROUTES[name][1], cores=f"tensor ({TC_ROUTES[name][2]})")
            elif name in REDUCE_ROUTES:  # in their own units
                row.update(source=REDUCE_ROUTES[name][1],
                           cores=f"CUDA ({REDUCE_ROUTES[name][2]})")
            if mod is fs:
                row["eval_launches"] = eval_launches[name]
                row["sample_launches"] = sample_launches[name]
            if mod in (fs, ig):
                row["memeff_true_launches"] = memeff_launches[name]
            if mod is lsm:  # phase 18's paths, IMNF_LINE_SEARCH=1
                row.update(eval_launches=search_eval_launches[name],
                           sample_launches=search_sample_launches[name],
                           merged_launches=merged_search_launches[name])
            elif mod not in (bu, fb):
                row["merged_launches"] = merged_launches[name]
            if mod is bu:
                row["eval_launches"] = tab_eval_launches[name]
            kernels.append(row)
    log(f"device_ms: {TIMINGS['dropped']} of {TIMINGS['runs']} profiled runs recorded a "
        "launch count that is no multiple of the calls (dropped launches)")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
