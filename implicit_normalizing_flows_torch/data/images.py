"""Structured synthetic images (``data/images.py:99-134`` of the JAX
package): random low-frequency cosine mixtures plus light noise, quantised
to uint8. The bench checkpoint was trained and benched on this
distribution. Returns the (n, c, h, w) uint8 images; the same seed gives
the same bytes as the JAX package's ``_synthetic_structured(...).x``."""
from __future__ import annotations

import numpy as np


def synthetic_structured(n, c, h, w, seed=0, n_modes=6):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    fy = rng.randint(0, 4, size=(n, c, n_modes))
    fx = rng.randint(0, 4, size=(n, c, n_modes))
    phase = rng.uniform(0, 2 * np.pi, size=(n, c, n_modes)).astype(np.float32)
    amp = rng.exponential(1.0, size=(n, c, n_modes)).astype(np.float32)
    basis_idx = fy * 4 + fx
    planes = 2 * np.pi * (np.arange(4)[:, None, None] * yy.ravel()
                          + np.arange(4)[None, :, None] * xx.ravel())
    basis = np.concatenate([np.cos(planes.reshape(16, -1)),
                            np.sin(planes.reshape(16, -1))]).astype(np.float32)
    coefs = np.zeros((n, c, 32), np.float32)
    rows = np.arange(n * c)[:, None]
    np.add.at(coefs.reshape(n * c, 32), (rows, basis_idx.reshape(n * c, -1)),
              (amp * np.cos(phase)).reshape(n * c, -1))
    np.add.at(coefs.reshape(n * c, 32), (rows, basis_idx.reshape(n * c, -1) + 16),
              (-amp * np.sin(phase)).reshape(n * c, -1))
    imgs = (coefs.reshape(n * c, 32) @ basis).reshape(n, c, h, w)
    imgs += 0.15 * rng.standard_normal(imgs.shape).astype(np.float32)
    lo = imgs.min(axis=(1, 2, 3), keepdims=True)
    hi = imgs.max(axis=(1, 2, 3), keepdims=True)
    return ((imgs - lo) / np.maximum(hi - lo, 1e-6) * 255).astype(np.uint8)
