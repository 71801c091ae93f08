"""Reader of the npz-tree checkpoint format (``training/checkpoints.py:
56-120`` of the JAX package): a ``__spec__`` JSON encodes the nesting, with
leaves inline JSON scalars or references into the archive's arrays. Pure
numpy; ``allow_pickle=False`` cannot execute code on load."""
from __future__ import annotations

import json

import numpy as np


def load_npz_tree(path: str):
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"]).decode())

        def dec(node):
            t, v = node["t"], node["v"]
            if t == "d":
                return {k: dec(x) for k, x in v.items()}
            if t == "l":
                return [dec(x) for x in v]
            if t == "t":
                return tuple(dec(x) for x in v)
            if t == "s":
                return v
            return z[v]

        return dec(spec)
