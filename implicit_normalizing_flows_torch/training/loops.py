"""Image evaluation step: dequantise -> flow -> per-example bits/dim and
solver telemetry.

Counterpart of ``make_image_step(model, None, train=False)`` of the JAX
package (``training/loops.py:105,214-226,246-345``) for the density task
without padding.
"""
from __future__ import annotations

import math

import torch


def standard_normal_logprob(z):
    """Per-example sum log N(z; 0, I)."""
    logZ = -0.5 * math.log(2 * math.pi)
    return torch.sum(logZ - z ** 2 / 2, dim=tuple(range(1, z.ndim)))


def dequantize(x_u8, noise, nvals=256):
    """(u8 + u) / nvals with the uniform noise ``u`` given
    (``loops.py:214-226``)."""
    return (x_u8.float() + noise) / nvals


def solver_stats(model):
    """Pool the blocks' 5-slot telemetry (``loops.py:45-75``): means of
    nstep and converged fractions, max of prot_break and rms_over_tol."""
    diags = [b.solver_diag for b in model.implicit_blocks()]
    if not diags:
        return {}
    d = torch.stack([t.to(diags[0].device) for t in diags])
    return {"broyden_nstep": d[:, 0].mean(), "broyden_converged": d[:, 1].mean(),
            "broyden_prot_break": d[:, 2].max(),
            "broyden_rms_over_tol": d[:, 3].max(),
            "broyden_converged_3eps": d[:, 4].mean()}


def make_image_eval_step(model, *, im_dim=3, imagesize=32, nvals=256):
    """Returns ``step(x_u8, draws) -> metrics`` with ``bpd_vec`` (B,),
    ``bpd``, ``logpz``, ``delta_logp``, ``z`` and the pooled solver stats.
    ``draws`` (``ops.logdet.Draws``) supplies the dequantisation noise, the
    probes and the roulette draws. The images are moved to the model's
    device."""
    dim = imagesize * imagesize * im_dim
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(x_u8, draws):
        x_u8 = torch.as_tensor(x_u8, device=device)
        x = dequantize(x_u8, draws.uniform(x_u8.shape, device), nvals)
        zeros = torch.zeros(x.shape[0], device=x.device)
        z, delta_logp = model(x, zeros, draws)
        logpz = standard_normal_logprob(z)
        logpx = logpz - delta_logp - math.log(nvals) * dim
        bpd_vec = -logpx / dim / math.log(2)
        m = {"bpd_vec": bpd_vec, "bpd": bpd_vec.mean(), "logpz": logpz.mean(),
             "delta_logp": (-delta_logp).mean(), "z": z}
        m.update(solver_stats(model))
        return m

    return step
