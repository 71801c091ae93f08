"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels of the forward solve from csrc/ with nvcc;
  2. each kernel against its plain PyTorch version at the CIFAR-10
     flagship's shapes (all three scales, batch 64, the committed
     checkpoint's weights, the blocks' real inputs): max error and time
     (CUDA events), with the plain version's time, the least time the card
     could take (bound) and one PyTorch library call's time for comparison;
  3. the whole fused solve against its plain version, per scale and mode;
  4. the flagship evaluation (bits/dim of 64 structured-synthetic images,
     seed 1) through the port's entry points, with every kernel's launch
     count over that run, and the bpd of the plain path on the same draws.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists the kernels as JSON. Without a CUDA device it exits non-zero and
prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "experiments", "cifar10_long_r4", "bench_ckpt.npz")
TPU_KERNEL = "implicit_normalizing_flows_tpu/ops/fused_solve.py:1921"
SOURCE = "implicit_normalizing_flows_torch/csrc/fused_solve.cu"
# H100 SXM published peaks (dense): HBM bytes/s, FP32 (CUDA cores) and bf16
# tensor-core FLOP/s
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
PASSES = {"f32": 1, "bf16": 1, "tf32": 3, "tf32x": 4}
BATCH, SIZE = 64, 32
EVAL_BATCHES = 3


def log(*a):
    print(*a, flush=True)


def _kernel_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _self_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) / 1e3


def device_ms(fn, reps=10):
    """Mean device time per call of fn(i), i < reps: the summed time of the
    CUDA kernels it launches (torch.profiler), so host launch latency and
    syncs between calls are not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    return sum(_self_ms(e) for e in _kernel_events(prof)) / reps


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


def build_model(dev):
    from implicit_normalizing_flows_torch.layers import LogitTransform
    from implicit_normalizing_flows_torch.models import ImplicitFlow
    from implicit_normalizing_flows_torch.training import (load_jax_checkpoint,
                                                           load_npz_tree)

    model = ImplicitFlow((BATCH, 3, SIZE, SIZE), n_blocks=[2, 2, 2],
                         intermediate_dim=512, init_layer=LogitTransform(0.05),
                         actnorm=True, coeff=0.9, vnorms="2222", n_dist="poisson",
                         kernels="3-1-3", preact=True, sn_atol=1e-3, sn_rtol=1e-3,
                         device=dev)
    load_jax_checkpoint(model, load_npz_tree(CKPT))
    return model.eval()


def capture_block_inputs(model, step, x_u8, draws):
    """The input of each scale's last implicit block in one eval run."""
    from implicit_normalizing_flows_torch.layers import ImplicitBlock

    seen, hooks = {}, []
    for s, scale in enumerate(model.transforms):
        block = [m for m in scale if isinstance(m, ImplicitBlock)][-1]
        hooks.append(block.register_forward_pre_hook(
            lambda mod, args, s=s: seen.__setitem__(s, (mod, args[0].detach().clone()))))
    try:
        step(x_u8, draws)
    finally:
        for h in hooks:
            h.remove()
    return [seen[s] for s in sorted(seen)]


def check_kernels(blocks, mode="tf32"):
    """Phase 2: every kernel vs its plain version at each scale's shapes."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    rows = {}
    for s, (block, x) in enumerate(blocks):
        B, c, H, W = x.shape
        HW, D, dev = H * W, c * H * W, x.device
        data = block.nnet_z.conv_forward_data()
        data = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in data.items()}
        wp = fs.prep_weights(data, mode)
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

        calls = {
            "conv3x3_in": (
                lambda: fs.conv3x3_in(x, idx, cnt, wp["w1"], b1, betas, data["preact"], mode, t1k),
                lambda: fs._conv3x3_in_plain(x, idx, cnt, wp["w1"], b1, betas, data["preact"], mode, t1p),
                lambda: torch.nn.functional.conv2d(x, w1, b1, padding=1),
                (t1k, t1p),
                4 * (B * D + 2 * w1.numel() + mid + B * mid * HW),
                B * mid * c * 9 * HW),
            "conv1x1_mid": (
                lambda: fs.conv1x1_mid(t1p, cnt, wp["w2"], b2, betas[2], mode, t2k, H, W),
                lambda: fs._conv1x1_mid_plain(t1p, cnt, wp["w2"], b2, betas[2], mode, t2p, H, W),
                lambda: torch.nn.functional.conv2d(t1p.view(B, mid, H, W), w2, b2),
                (t2k, t2p),
                4 * (2 * B * mid * HW + 2 * w2.numel() + mid),
                B * mid * mid * HW),
            "conv3x3_out": (
                lambda: fs.conv3x3_out(t2p, idx, cnt, wp["w3"], b3, mode, xf, -1.0, xf, gk, H, W),
                lambda: fs._conv3x3_out_plain(t2p, idx, cnt, wp["w3"], b3, mode, xf, -1.0, xf, gp, H, W),
                lambda: torch.nn.functional.conv2d(t2p.view(B, mid, H, W), w3, b3, padding=1),
                (gk, gp),
                4 * (B * mid * HW + 2 * w3.numel() + c + 3 * B * D),
                B * c * mid * 9 * HW),
        }
        for name, (kern, plain, lib, (out_k, out_p), nbytes, macs) in calls.items():
            plain()
            kern()
            torch.cuda.synchronize()
            err = rel_err(out_k, out_p)
            # float32 sums in another order over K <= 4608 products
            assert math.isfinite(err) and err <= 1e-4, (name, s, err)
            ms, pms, lms = (device_ms(lambda i, f=f: f()) for f in (kern, plain, lib))
            bms, by = bound_ms(nbytes, macs, mode)
            log(f"kernel {name} scale{s} ({c}x{H}x{W}, B={B}, {mode}): "
                f"max_rel_err {err:.3e} ms {ms:.4f} plain_ms {pms:.4f} "
                f"library_ms {lms:.4f} bound_ms {bms:.4f} ({by})")
            rows.setdefault(name, {})[s] = dict(
                max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
                plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)

        # broyden_step on a mid-solve state: nk planes written per example
        nk, K = 10, 30
        gen = torch.Generator(device=dev).manual_seed(s)
        rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
        st0 = {k: rnd(B, D) for k in ("Z", "G", "UPD", "ZN", "GN", "BZ", "BG")}
        # a secant-like step: delta_g = -0.5 delta_z keeps <vT, dg> away from 0
        st0["G"] = st0["GN"] + 0.5 * st0["UPD"]
        st0["U"], st0["V"] = torch.zeros(B, K, D, device=dev), torch.zeros(B, K, D, device=dev)
        st0["U"][:, :nk], st0["V"][:, :nk] = 0.01 * rnd(B, nk, D), 0.01 * rnd(B, nk, D)
        st0["ist"] = torch.tensor([nk, nk, 0, 0], dtype=torch.int32, device=dev).repeat(B, 1)
        norm = st0["GN"].norm(dim=1)
        st0["fst"] = torch.stack([norm * 1.5, norm * 2, norm * 3], 1).contiguous()
        kw = dict(eps=1e-3, cap=K, patience=5, rtol=0.05, guard_eps=3e-3, newton=True)
        outs, reps = {}, 10
        for tag, fn in (("kernel", fs.broyden_step), ("plain", fs._broyden_step_plain)):
            io = torch.zeros(B, dtype=torch.int32, device=dev)
            co = torch.zeros(1, dtype=torch.int32, device=dev)
            copies = [{k: v.clone() for k, v in st0.items()} for _ in range(reps)]
            run = lambda i: fn(fs.PHASE_STEP, idx, cnt, io, co, copies[i], **kw)
            outs[tag + "_ms"] = device_ms(run, reps)  # copy 0 ran twice: unused
            st = {k: v.clone() for k, v in st0.items()}
            fn(fs.PHASE_STEP, idx, cnt, io, co, st, **kw)
            torch.cuda.synchronize()
            outs[tag] = (st, io[:int(co.item())].sort().values)
            del copies
        (stk, ik), (stp, ip) = outs["kernel"], outs["plain"]
        assert torch.equal(ik, ip), (s, ik, ip)
        assert torch.equal(stk["ist"], stp["ist"]), s
        err = max(rel_err(stk[k].float(), stp[k].float()) for k in stk)
        assert math.isfinite(err) and err <= 1e-4, ("broyden_step", s, err)
        nbytes = 4 * B * D * (2 * nk + 2 + 4 + 6)
        bms, by = bound_ms(nbytes, 0, "f32")
        ms, pms = outs["kernel_ms"], outs["plain_ms"]
        log(f"kernel broyden_step scale{s} (B={B}, D={D}, nstep {nk}): max_rel_err "
            f"{err:.3e} ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by})")
        rows.setdefault("broyden_step", {})[s] = dict(
            max_abs_err=max(float((stk[k].float() - stp[k].float()).abs().max()) for k in stk),
            ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=by)
    return rows


def check_solves(blocks):
    """Phase 3: whole solve, kernels vs plain, per scale and mode.

    Both are solves of the same map whose iterates differ only through
    float sums in another order. At the production tolerance (eps 1e-6,
    about 1e-6 per element) the split modes sit at their own rounding
    floor (about 2^-18 per product), so which iteration first dips under
    the tolerance is noise there: those runs are held to equal converged and
    protective-break flags and close roots. Per-example iteration counts
    must agree within one where the tolerance lies above the floor: in f32,
    and in the split modes at eps 1e-5."""
    from implicit_normalizing_flows_torch.ops import fused_solve as fs

    kw = dict(threshold=30, stall_patience=5, stall_rtol=0.05, stall_guard=3.0,
              newton_init=True, warm_start=True)
    ladder = lambda start: dict(tail_mode=("tf32x", "f32"), tail_start=start)
    configs = [("f32", 1e-6, {}), ("tf32", 1e-6, {}), ("tf32x", 1e-6, {}),
               ("tf32", 1e-6, ladder(15)), ("tf32", 1e-5, {}),
               ("tf32x", 1e-5, {}), ("tf32", 1e-5, ladder(6))]
    for s, (block, x) in enumerate(blocks):
        dx = block.nnet_x.conv_forward_data()
        dz = block.nnet_z.conv_forward_data()
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
                dz_max = float((rk.result - rp.result).abs().max())
                dn = (rk.nstep - rp.nstep).abs().long()
                label = f"{mode}{'+ladder' if extra else ''} eps {eps:g}"
                log(f"solve scale{s} {label}: max|dz| {dz_max:.3e} "
                    f"|d nstep| counts {torch.bincount(dn).tolist()} "
                    f"nstep mean {rk.nstep.float().mean():.2f}/{rp.nstep.float().mean():.2f} "
                    f"converged {rk.converged.float().mean():.3f}/{rp.converged.float().mean():.3f} "
                    f"prot {int(rk.prot_break.sum())}/{int(rp.prot_break.sum())} "
                    f"s {tk:.3f}/{tp:.3f} (kernels/plain)")
                assert torch.isfinite(rk.result).all()
                assert torch.equal(rk.prot_break, rp.prot_break), (s, label)
                assert torch.equal(rk.converged, rp.converged), (s, label)
                assert dz_max <= 5e-4, (s, label, dz_max)
                if mode == "f32" or eps > 1e-6:
                    assert int(dn.max()) <= 1, (s, label, int(dn.max()))


def profile_batch(model, step, x_u8, draws):
    """Device time by kernel over one main-path batch, the device's idle
    share (1 - summed kernel time / wall time), and the host-clock time
    spent in the blocks' solves (synchronised around each)."""
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
        b.solve = timed(b.solve)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(x_u8, draws)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        for b in blocks:
            del b.solve
    log(f"profile batch: solves {sum(solve_ms):.1f} ms wall "
        f"({', '.join(f'{t:.1f}' for t in solve_ms)} per block), rest "
        f"{wall - sum(solve_ms):.1f} ms")
    events = _kernel_events(prof)
    busy = sum(_self_ms(e) for e in events)
    ours = sum(_self_ms(e) for e in events if "broyden_step" in e.key
               or "conv_gemm_swish" in e.key or "conv3x3_out" in e.key)
    log(f"profile batch: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}, solve kernels {ours:.1f} ms, other device work "
        f"{busy - ours:.1f} ms")
    for e in sorted(events, key=_self_ms, reverse=True)[:15]:
        log(f"  {_self_ms(e):9.2f} ms  x{e.count:<5d} {e.key[:110]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from implicit_normalizing_flows_torch.data import synthetic_structured
    from implicit_normalizing_flows_torch.layers import implicit_block
    from implicit_normalizing_flows_torch.ops import cuda_build
    from implicit_normalizing_flows_torch.ops import fused_solve as fs
    from implicit_normalizing_flows_torch.ops.broyden import triage_metrics
    from implicit_normalizing_flows_torch.ops.logdet import Draws
    from implicit_normalizing_flows_torch.training import make_image_eval_step

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 1: build
    t0 = time.perf_counter()
    report = cuda_build.build("fused_solve", report=True)
    log(f"phase1 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(report, HERE)}")

    model = build_model(dev)
    step = make_image_eval_step(model, imagesize=SIZE)
    # a host tensor, as a user hands it over: the step moves it to the card
    x_u8 = torch.from_numpy(synthetic_structured(BATCH, 3, SIZE, SIZE, seed=1))
    draws = lambda i: Draws(torch.Generator(device=dev).manual_seed(1000 + i))

    # phase 2: kernels vs plain at each scale's real inputs
    blocks = capture_block_inputs(model, step, x_u8, draws(99))
    rows = check_kernels(blocks)
    # phase 3: whole solves
    check_solves(blocks)

    # phase 4: the main path
    fs.reset_launch_counts()
    bpds, bpd0 = [], None
    for i in range(EVAL_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(x_u8, draws(i))
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
    launches = fs.launch_counts()
    log("kernels " + json.dumps(launches))
    assert all(n > 0 for n in launches.values()), launches

    profile_batch(model, step, x_u8, draws(0))

    # the plain path on batch 0's draws
    implicit_block.fused_broyden_solve = fs.fused_broyden_solve_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp = step(x_u8, draws(0))
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
    finally:
        implicit_block.fused_broyden_solve = fs.fused_broyden_solve
    dbpd = abs(float(mp["bpd"]) - bpds[0])
    log(f"plain path batch 0: bpd {float(mp['bpd']):.5f} |d mean bpd| {dbpd:.2e} "
        f"max|d bpd_vec| {float((mp['bpd_vec'] - bpd0).abs().max()):.2e} ms {pms:.1f}")
    assert dbpd <= 1e-3, dbpd
    assert 1.0 < bpds[0] < 8.0, bpds

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=TPU_KERNEL,
                    launches=launches[name], **rows[name][0])
               for name in fs.KERNELS]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
