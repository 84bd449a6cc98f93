"""The divisibility rule that every sharding decision reduces to (the port
keeps only this piece of ``repro.distributed.sharding``; the rest of that
module shards the LM zoo)."""
from __future__ import annotations

import numpy as np


def divisible(n, mesh_shape, axes) -> bool:
    """A dim of size ``n`` shards over ``axes`` only when their combined
    size exceeds 1 AND divides ``n`` evenly; otherwise the layout degrades
    to replicated.  ``mesh_shape`` maps axis names to sizes."""
    if isinstance(axes, str):
        axes = (axes,)
    size = int(np.prod([mesh_shape.get(a, 1) for a in axes]))
    return size > 1 and n % size == 0
