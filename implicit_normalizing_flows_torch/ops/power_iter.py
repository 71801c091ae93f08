"""Induced-norm power iteration for the (2, 2) norms the CIFAR and tabular
recipes use (vnorms ``2222``, ``222222``). Counterpart of
``ops/power_iter.py:132-250`` of the JAX package: ``sigma = <u, W v>`` is
differentiable w.r.t. ``W``; ``u``/``v`` are refreshed out of band by the
power iteration (the EMA-eval sigma refresh, ``train_img.py:479-481``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAX_POWER_ITERS = 200  # reference cap: mixed_lipschitz.py:99,284,336


def l2_normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def conv_apply(weight, x, padding):
    """NCHW stride-1 conv2d with symmetric int padding, in x's dtype.

    A bfloat16 conv on the CPU runs in float32 and rounds its output: the
    result is the same (bfloat16 products are exact in float32, sums in
    float32 as XLA and cuDNN take them), but torch's CPU bfloat16 conv
    differentiates its own VJP wrongly (the gradient of <J^T a, e> w.r.t.
    the weight, which the Neumann estimator's final term needs, comes out
    uncorrelated with the float32 one)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv2d(x.float(), weight.float(), padding=padding).to(x.dtype)
    return F.conv2d(x, weight, padding=padding)


def conv_transpose_apply(weight, y, padding):
    """Adjoint of :func:`conv_apply` for stride 1."""
    return F.conv_transpose2d(y, weight, padding=padding)


def dense_sigma(weight, u, v):
    return torch.dot(u, weight @ v)


def conv_sigma(weight, u, v, x_shape, padding):
    """sigma = <u, conv(v)> (mixed_lipschitz.py:378-380)."""
    wv = conv_apply(weight, v.reshape(x_shape), padding)
    return torch.dot(u.reshape(-1), wv.reshape(-1))


def _normalize_rows(a):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-12)


def _run(step, u, v, n_iterations, atol, rtol):
    """L independent power iterations, one per row of ``u`` (L, m) and ``v``
    (L, n): a fixed budget, or the reference's adaptive test with a 200 cap
    (mixed_lipschitz.py:114-120) for each row on its own, a row that has met
    it keeping its u and v while the others go on. One host read per
    iteration for all L."""
    if n_iterations is not None:
        for _ in range(n_iterations):
            u, v = step(u, v)
        return u, v
    if atol is None or rtol is None:
        raise ValueError("Need one of n_iterations or (atol, rtol).")
    active = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    for _ in range(MAX_POWER_ITERS):
        new_u, new_v = step(u, v)
        err_u = torch.linalg.vector_norm(new_u - u, dim=1) / new_u.shape[1] ** 0.5
        err_v = torch.linalg.vector_norm(new_v - v, dim=1) / new_v.shape[1] ** 0.5
        done = ((err_u < atol + rtol * new_u.amax(dim=1))
                & (err_v < atol + rtol * new_v.amax(dim=1)))
        u = torch.where(active[:, None], new_u, u)
        v = torch.where(active[:, None], new_v, v)
        active = active & ~done
        if not bool(active.any()):
            break
    return u, v


@torch.no_grad()
def induced_norm_dense_stack(weight, u, v, n_iterations=None, atol=None, rtol=None):
    """The power iteration of L dense layers of one shape at once
    (``weight`` (L, out, in), ``u`` (L, out), ``v`` (L, in)), each with its
    own stop (``_run``)."""
    def step(u, v):
        u2 = _normalize_rows(torch.bmm(weight, v[:, :, None])[:, :, 0])
        return u2, _normalize_rows(torch.bmm(weight.transpose(1, 2), u2[:, :, None])[:, :, 0])
    return _run(step, u, v, n_iterations, atol, rtol)


def induced_norm_dense(weight, u, v, n_iterations=None, atol=None, rtol=None):
    """Power-iterate ``u = N(W v); v = N(W^T u)`` for one dense weight."""
    u, v = induced_norm_dense_stack(weight[None], u[None], v[None], n_iterations, atol, rtol)
    return u[0], v[0]


@torch.no_grad()
def induced_norm_conv(weight, u, v, x_shape, out_shape, padding,
                      n_iterations=None, atol=None, rtol=None):
    """Power iteration through a kxk conv as one linear operator
    (mixed_lipschitz.py:328-376)."""
    def step(u, v):
        u2 = _normalize_rows(conv_apply(weight, v.reshape(x_shape), padding).reshape(1, -1))
        v_s = conv_transpose_apply(weight, u2.reshape(out_shape), padding)
        return u2, _normalize_rows(v_s.reshape(1, -1))
    u, v = _run(step, u[None], v[None], n_iterations, atol, rtol)
    return u[0], v[0]
