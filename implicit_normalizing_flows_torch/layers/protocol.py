"""The flow protocol of the port.

Counterpart of ``implicit_normalizing_flows_tpu/layers/protocol.py``. The JAX
package keeps numbers in an explicit ``{'params', 'state'}`` pytree; here a
layer is an ``nn.Module`` that owns its parameters and buffers, named so that
the module path of every tensor equals its path in the JAX pytree
(``training.convert`` maps one onto the other).

``forward(x, logpx=None, draws=None, train=False) -> (y, logpy)``;
``logpy`` is None iff ``logpx`` is None. ``inverse(y, logpy=None,
draws=None) -> (x, logpx)`` runs the layer backwards (sampling), adding
the log-det that ``forward`` subtracts. ``draws`` (``ops.logdet.Draws``)
supplies every random number; ``train`` selects the training estimator and
the implicit gradient of the implicit blocks. Layers run under autograd.
"""
from __future__ import annotations

from torch import nn


def make_vars(params=None, state=None) -> dict:
    """The JAX variables layout ``{'params': ..., 'state': ...}``."""
    return {"params": params if params is not None else {},
            "state": state if state is not None else {}}


class Flow(nn.Module):
    """Base class of invertible layers."""

    def forward(self, x, logpx=None, draws=None, train=False):
        raise NotImplementedError

    def inverse(self, y, logpy=None, draws=None):
        raise NotImplementedError
