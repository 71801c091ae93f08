"""Plain-PyTorch pieces of the solver around the fused solve: the Banach
fallback for protective-break rows and the host-side triage line.
Counterpart of ``ops/broyden.py:340-442`` of the JAX package."""
from __future__ import annotations

import torch


@torch.no_grad()
def fixed_point_iteration(g, y, threshold=1000, eps=1e-5):
    """Picard iteration ``x <- g(x)`` from ``g(y)`` with the reference's
    elementwise stop ``(x - x_prev)^2 / (eps + eps|y|) < 1``
    (``implicit_block.py:17-28``); converged rows freeze while the others
    continue."""
    shape = y.shape
    y2 = y.reshape(y.shape[0], -1)
    g2 = lambda x: g(x.reshape(shape)).reshape(y2.shape)
    tol = eps + eps * torch.abs(y2)
    row_done = lambda x, xp: torch.all((x - xp) ** 2 / tol < 1.0, dim=1)
    x, x_prev = g2(y2), y2
    active = ~row_done(x, x_prev)
    i = 0
    while bool(active.any()) and i <= threshold:
        a = active[:, None]
        x_new = torch.where(a, g2(x), x)
        x_prev = torch.where(a, x, x_prev)
        x = x_new
        active = active & ~row_done(x, x_prev)
        i += 1
    return x.reshape(shape)


def triage_metrics(m, name: str = "forward") -> str | None:
    """Warning line when the protective break fired (the per-row Banach
    fallback has already patched those rows), else None."""
    prot = float(m.get("broyden_prot_break", 0.0))
    if prot <= 0:
        return None
    return (f"WARNING: Hit Protective Break in {name} solve "
            f"(per-row Banach fallback applied; "
            f"BroydenIters {float(m.get('broyden_nstep', 0.0)):.1f}, "
            f"Converged {float(m.get('broyden_converged', 0.0)):.2f})")
