"""JAX variables -> the port's parameters and buffers.

The port names its modules so that a tensor's module path equals its path in
the JAX ``{'params', 'state'}`` pytree, with one exception: a net's state is
a list of per-layer dicts in JAX but lives under ``<net>.layers.<i>`` here.
Telemetry leaves (estimator moments, solver diagnostics, ActNorm's
``initialized`` flag) are not model state in the port and are dropped.
"""
from __future__ import annotations

import numpy as np
import torch

_DROPPED = {"initialized", "last_n_samples", "last_firmom", "last_secmom",
            "solver_diag"}
_NETS = ("nnet_x", "nnet_z")


def _walk(node, prefix, in_state, out, compact_f16):
    if isinstance(node, dict):
        for k, v in node.items():
            if k in _DROPPED:
                continue
            if in_state and k in _NETS and isinstance(v, (list, tuple)):
                _walk(v, f"{prefix}{k}.layers.", in_state, out, compact_f16)
            else:
                _walk(v, f"{prefix}{k}.", in_state, out, compact_f16)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}{i}.", in_state, out, compact_f16)
    else:
        a = np.asarray(node)
        if compact_f16 and a.dtype == np.float16:
            a = a.astype(np.float32)
        out[prefix[:-1]] = torch.from_numpy(np.array(a))


def jax_variables_to_torch(params, state, *, compact_f16=False) -> dict:
    """``{name: tensor}`` for ``model.load_state_dict`` from the JAX
    ``params`` / ``state`` trees as numpy arrays (``load_npz_tree``, or
    ``np.asarray`` of live JAX variables). ``compact_f16`` (the committed
    bench checkpoint's flag) casts its float16 storage to float32."""
    out: dict = {}
    _walk(params, "", False, out, compact_f16)
    _walk(state, "", True, out, compact_f16)
    return out


def load_jax_checkpoint(model, ckpt) -> None:
    """Load a JAX checkpoint dict (``{'params', 'state', ...}``) into
    ``model`` in place; every parameter and buffer must be covered."""
    sd = jax_variables_to_torch(ckpt["params"], ckpt["state"],
                                compact_f16=bool(ckpt.get("compact_f16", False)))
    model.load_state_dict(sd, strict=True)
