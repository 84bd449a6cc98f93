"""The smooth data-fit term (PyTorch port): squared loss only.

The expressions are the reference's literal ones: ``residual`` is ``y - u``,
``primal_value`` is ``0.5 * <resid, resid>``, ``dual_value`` is
``0.5*<y,y> - 0.5*<y - lam*theta, y - lam*theta>``.  The logistic loss of the
JAX package is not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SquaredLoss:
    """f(u) = 0.5 * ||y - u||^2 — the paper's loss; TLFre applies."""
    name: str = "squared"

    def grad(self, y, u):
        return u - y

    def residual(self, y, u):
        return y - u

    def residual_at_zero(self, y):
        return y

    def primal_value(self, y, fit, resid):
        return 0.5 * torch.dot(resid, resid)

    def dual_value(self, y, theta, lam):
        d = y - lam * theta
        return 0.5 * torch.dot(y, y) - 0.5 * torch.dot(d, d)

    def gap_scale(self, y):
        return torch.clamp(0.5 * torch.dot(y, y), min=1e-30)

    def gap_scale_host(self, y) -> float:
        return max(float(0.5 * torch.dot(y, y)), 1e-30)

    def effective_tol(self, tol, dtype) -> float:
        """Dtype-aware gap tolerance: below ~64 ulp the gap is rounding
        noise, so a float32 run would spin to ``max_iter``.  The floor is far
        below every realistic float64 tolerance."""
        return max(float(tol), 64.0 * torch.finfo(dtype).eps)


SQUARED = SquaredLoss()


def get_loss(name):
    """Resolve a loss by name; passes loss instances through."""
    if isinstance(name, SquaredLoss):
        return name
    if name == SQUARED.name:
        return SQUARED
    if name == "logistic":
        raise NotImplementedError(
            "the logistic loss is not ported yet (ROADMAP queue 1, item 10)")
    raise ValueError(f"unknown loss {name!r}: expected 'squared'")
