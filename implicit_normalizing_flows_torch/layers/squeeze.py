"""Space-to-depth squeeze (``layers/squeeze.py`` of the JAX package)."""
from __future__ import annotations

from .protocol import Flow


def squeeze(x, factor=2):
    """[B, C, H*r, W*r] -> [B, C*r^2, H, W] (squeeze.py:32-45)."""
    b, c, h, w = x.shape
    oh, ow = h // factor, w // factor
    x = x.reshape(b, c, oh, factor, ow, factor).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, c * factor * factor, oh, ow)


def unsqueeze(x, factor=2):
    """Inverse of :func:`squeeze`, [B, C*r^2, H, W] -> [B, C, H*r, W*r]
    (squeeze.py:16-22)."""
    b, c, h, w = x.shape
    oc = c // (factor * factor)
    x = x.reshape(b, oc, factor, factor, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, oc, h * factor, w * factor)


class SqueezeLayer(Flow):
    """Volume preserving: logp passes through."""

    def __init__(self, downscale_factor=2):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x, logpx=None, draws=None, train=False):
        return squeeze(x, self.downscale_factor), logpx

    def inverse(self, y, logpy=None, draws=None):
        return unsqueeze(y, self.downscale_factor), logpy
