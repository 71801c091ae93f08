"""Render a grid of samples at temperature tau from the CIFAR-10 flagship
with the PyTorch port (counterpart of ``qualitative_samples.py``).

  python3 qualitative_samples_torch.py --out samples.png --nrow 8 --temperature 0.8

The model is the flagship of ``run_cifar10.sh`` (blocks 2-2-2, idim 512,
kernels 3-1-3, swish, preact, actnorm, ``LogitTransform(0.05)``, coeff
0.9), loaded from an npz-tree checkpoint (default: the committed
``experiments/cifar10_long_r4/bench_ckpt.npz``). With ``--use-ema True``
and an ``ema`` tree in the checkpoint the EMA weights are sampled, after a
power iteration against them (``qualitative_samples.py:75-81``). The
latents ``tau * N(0, 1)`` come from a seeded ``torch.Generator`` on the
device; ``ImplicitFlow.inverse`` maps them back to images in [0, 1]. The
model runs on ``--device`` (the card unless the CPU is asked for). The
grid is written as an 8-bit PNG by the standard library.
"""
import argparse
import math
import os
import struct
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "experiments", "cifar10_long_r4", "bench_ckpt.npz")
IM_DIM = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default=CKPT)
    p.add_argument("--out", type=str, default="samples.png")
    p.add_argument("--nrow", type=int, default=8)
    p.add_argument("--nsamples", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use-ema", type=eval, choices=[True, False], default=True)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_flagship(ckpt_path, device, use_ema=True):
    """The flagship on ``device`` with the checkpoint's weights (its EMA
    weights, re-normalised, when ``use_ema`` and the tree has them)."""
    from implicit_normalizing_flows_torch.layers import LogitTransform
    from implicit_normalizing_flows_torch.models import ImplicitFlow
    from implicit_normalizing_flows_torch.training import (load_jax_checkpoint,
                                                           load_npz_tree)

    ckpt = load_npz_tree(ckpt_path)
    model = ImplicitFlow((1, IM_DIM, 32, 32), n_blocks=[2, 2, 2], intermediate_dim=512,
                         init_layer=LogitTransform(0.05), actnorm=True, coeff=0.9,
                         vnorms="2222", n_dist="poisson", kernels="3-1-3", preact=True,
                         sn_atol=1e-3, sn_rtol=1e-3, n_exact_terms=10,
                         grad_in_forward=False, device=device)
    ema = use_ema and "ema" in ckpt
    load_jax_checkpoint(model, dict(ckpt, params=ckpt["ema"]) if ema else ckpt)
    if ema:
        # the checkpoint's power-iteration state tracks the live weights
        model.update_lipschitz()
    return model


@torch.no_grad()
def sample(model, nsamples, temperature, seed):
    """(nsamples, IM_DIM, H, W) images from ``temperature * N(0, 1)``
    latents drawn by a generator seeded with ``seed`` on the model's
    device."""
    device = next(model.parameters()).device
    dim = sum(math.prod(d) for d in model.dims)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = temperature * torch.randn(nsamples, dim, generator=gen, device=device)
    x, _ = model.inverse(z)
    return x[:, :IM_DIM]


def grid_pixels(images, nrow):
    """(rows, cols, c) uint8 grid of (N, c, H, W) images in [0, 1], 2-pixel
    white gutters (``qualitative_samples.save_grid``)."""
    n, c, h, w = images.shape
    ncol = int(math.ceil(n / nrow))
    grid = np.ones((c, ncol * h + (ncol - 1) * 2, nrow * w + (nrow - 1) * 2), np.float32)
    for i in range(n):
        r, cc = divmod(i, nrow)
        grid[:, r * (h + 2):r * (h + 2) + h, cc * (w + 2):cc * (w + 2) + w] = images[i]
    return (np.clip(grid, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def write_png(arr, path):
    """An 8-bit gray (rows, cols, 1) or RGB (rows, cols, 3) PNG: one IDAT of
    unfiltered rows."""
    rows, cols, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"write_png takes 1 or 3 channels, got {c}")

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(rows))
    ihdr = struct.pack(">IIBBBBB", cols, rows, 8, 0 if c == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def main(argv=None):
    args = parse_args(argv)
    model = load_flagship(args.ckpt, torch.device(args.device), args.use_ema)
    x = sample(model, args.nsamples, args.temperature, args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(grid_pixels(x.cpu().numpy(), args.nrow), args.out)
    print(f"wrote {args.nsamples} samples at tau={args.temperature} to {args.out}")


if __name__ == "__main__":
    main()
