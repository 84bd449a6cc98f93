"""The smooth data-fit term (PyTorch port): squared and logistic losses.

The squared-loss expressions are the reference's literal ones: ``residual``
is ``y - u``, ``primal_value`` is ``0.5 * <resid, resid>``, ``dual_value``
is ``0.5*<y,y> - 0.5*<y - lam*theta, y - lam*theta>``.

``gamma`` is the smoothness constant of the per-sample loss: 1 for squared
loss, 1/4 for logistic.  It scales the FISTA step (``L = gamma *
||X||^2``) and the Gap-Safe radius (``sqrt(2*gamma*gap)/lam``).
``supports_masked_rows`` marks whether zero-padded rows are neutral for the
loss: the fold-batched CV embeds each fold as a zero-masked copy of the
design, which is exact for squared loss but not for logistic (``f(y=0,
u=0) = log 2``), so CV refuses a loss without it.

``dual_value`` takes ``lam`` as a scalar, or as an ``(L, 1)`` column for L
grid points at once (the Gap-Safe radii of a whole grid); the squared
loss's values also take a leading fold axis (``y`` (K, 1, N), ``lam`` (K,
L, 1); ``resid`` (K, N)).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_LOG2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class Loss:
    """Base interface; concrete losses override every method."""
    name: str = "base"
    gamma: float = 1.0               # smoothness constant of the unit loss
    supports_masked_rows: bool = True

    def grad(self, y, u):
        raise NotImplementedError

    def residual(self, y, u):
        raise NotImplementedError

    def residual_at_zero(self, y):
        raise NotImplementedError

    def primal_value(self, y, fit, resid):
        raise NotImplementedError

    def dual_value(self, y, theta, lam):
        raise NotImplementedError

    def gap_scale(self, y):
        raise NotImplementedError

    def gap_scale_host(self, y) -> float:
        raise NotImplementedError

    def effective_tol(self, tol, dtype) -> float:
        """Dtype-aware gap tolerance: below ~64 ulp the gap is rounding
        noise, so a float32 run would spin to ``max_iter``.  The floor is far
        below every realistic float64 tolerance."""
        return max(float(tol), 64.0 * torch.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class SquaredLoss(Loss):
    """f(u) = 0.5 * ||y - u||^2 — the paper's loss; TLFre applies."""
    name: str = "squared"
    gamma: float = 1.0
    supports_masked_rows: bool = True

    def grad(self, y, u):
        return u - y

    def residual(self, y, u):
        return y - u

    def residual_at_zero(self, y):
        return y

    def primal_value(self, y, fit, resid):
        if resid.dim() == 1:
            return 0.5 * torch.dot(resid, resid)
        return 0.5 * torch.sum(resid * resid, dim=-1)

    def dual_value(self, y, theta, lam):
        d = y - lam * theta
        if d.dim() == 1:
            return 0.5 * torch.dot(y, y) - 0.5 * torch.dot(d, d)
        return 0.5 * torch.sum(y * y, dim=-1) - 0.5 * torch.sum(d * d, dim=-1)

    def gap_scale(self, y):
        return torch.clamp(0.5 * torch.dot(y, y), min=1e-30)

    def gap_scale_host(self, y) -> float:
        return max(float(0.5 * torch.dot(y, y)), 1e-30)


@dataclasses.dataclass(frozen=True)
class LogisticLoss(Loss):
    """f(u) = sum(log(1 + e^u) - y*u), y in {0, 1}.

    The dual feasible point is the scaled residual ``theta = s*(y -
    sigmoid(u))/lam`` with the Lemma-9 scaling ``s in (0, 1]``; then ``pi =
    y - lam*theta`` lies in (0, 1), so the binary-entropy dual is finite and
    the squared-loss scaling (``dual_scaling_sgl``) is reused as it is.
    TLFre's Theorem-12 ball is squared-loss algebra, so logistic paths
    screen with Gap-Safe balls only.
    """
    name: str = "logistic"
    gamma: float = 0.25
    supports_masked_rows: bool = False

    def grad(self, y, u):
        return torch.sigmoid(u) - y

    def residual(self, y, u):
        return y - torch.sigmoid(u)

    def residual_at_zero(self, y):
        return y - 0.5

    def primal_value(self, y, fit, resid):
        # log(1 + e^u) - y*u via logaddexp: stable for |u| large
        return torch.sum(torch.logaddexp(torch.zeros_like(fit), fit) - y * fit)

    def dual_value(self, y, theta, lam):
        # negative binary entropy of pi = y - lam*theta; the clip only
        # guards rounding (Lemma-9 scaled duals satisfy pi in (0, 1))
        pi = y - lam * theta
        eps = torch.finfo(pi.dtype).eps
        pi = torch.clamp(pi, eps, 1.0 - eps)
        return -torch.sum(pi * torch.log(pi) + (1.0 - pi) * torch.log1p(-pi),
                          dim=-1)

    def gap_scale(self, y):
        # primal value at beta = 0 (the analogue of 0.5*||y||^2)
        return torch.as_tensor(y.shape[0] * _LOG2, dtype=y.dtype,
                               device=y.device)

    def gap_scale_host(self, y) -> float:
        return float(y.shape[0]) * _LOG2


SQUARED = SquaredLoss()
LOGISTIC = LogisticLoss()

_REGISTRY = {SQUARED.name: SQUARED, LOGISTIC.name: LOGISTIC}


def get_loss(name) -> Loss:
    """Resolve a loss by name; passes ``Loss`` instances through."""
    if isinstance(name, Loss):
        return name
    loss = _REGISTRY.get(name)
    if loss is None:
        raise ValueError(
            f"unknown loss {name!r}: expected one of {sorted(_REGISTRY)}")
    return loss
