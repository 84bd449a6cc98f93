"""Path result and grid protocol (PyTorch port of the parts of
``repro.core.path`` that the batched engine uses).

The paper's protocol (Section 6): a geometric grid of 100 lambda values from
lambda_max down to 0.01*lambda_max.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PathResult:
    lambdas: np.ndarray                 # (J,)
    betas: np.ndarray                   # (J, p) float64, on the host
    lam_max: float
    screen_time: float                  # total screening seconds
    solve_time: float                   # total solver seconds
    setup_time: float                   # norms / lipschitz precompute
    iters: np.ndarray                   # (J,)
    kept_features: np.ndarray           # (J,) columns entering the solver
    kept_groups: Optional[np.ndarray] = None
    stats: Optional[object] = None      # EngineStats


def default_lambda_grid(lam_max: float, n: int = 100,
                        min_ratio: float = 0.01) -> np.ndarray:
    """n values equally spaced on log(lambda/lambda_max) from 1.0 down to
    min_ratio — INCLUDING the lam_max endpoint."""
    return lam_max * np.logspace(0.0, np.log10(min_ratio), n)


def _bucket(n: int, minimum: int = 64) -> int:
    """Next power-of-two bucket; keeps solver shapes to O(log p)."""
    b = minimum
    while b < n:
        b *= 2
    return b
