"""Fenchel-dual machinery for SGL (paper Section 3), PyTorch port: the
shrinkage operator ``S_gamma`` (Eq. 1) and the SGL penalty."""
from __future__ import annotations

import torch

from .groups import GroupSpec, group_norms


def shrink(w: torch.Tensor, gamma=1.0) -> torch.Tensor:
    """Soft-threshold / shrinkage operator S_gamma (Eq. 1)."""
    return torch.sign(w) * torch.clamp(torch.abs(w) - gamma, min=0.0)


def sgl_feasibility_margin(spec: GroupSpec, xt_theta: torch.Tensor,
                           alpha) -> torch.Tensor:
    """Per-group feasibility margin of the Fenchel dual (13):
    ``||S_w(X_g^T theta)|| - alpha*w_g``; theta is dual-feasible iff every
    entry is <= 0.  The shrinkage threshold is the adaptive per-feature
    weight when the spec carries one (``S_1`` otherwise, the paper's
    case)."""
    gamma = (1.0 if spec.feature_weights is None
             else spec.feature_weights.to(xt_theta.dtype))
    return (group_norms(spec, shrink(xt_theta, gamma))
            - alpha * spec.weights.to(xt_theta.dtype))


def sgl_dual_feasible(spec: GroupSpec, xt_theta: torch.Tensor, alpha,
                      tol: float = 0.0) -> torch.Tensor:
    return torch.all(sgl_feasibility_margin(spec, xt_theta, alpha) <= tol)


def weighted_l1(spec: GroupSpec, beta) -> torch.Tensor:
    """l1 part of the SGL penalty: ``sum w_f |beta_f|`` with adaptive feature
    weights, the classical ``sum |beta_f|`` otherwise."""
    if spec.feature_weights is None:
        return torch.sum(torch.abs(beta))
    return torch.sum(spec.feature_weights.to(beta.dtype) * torch.abs(beta))


def sgl_penalty(spec: GroupSpec, beta, alpha) -> torch.Tensor:
    """SGL penalty ``alpha * sum_g W_g ||beta_g|| + sum_f w_f |beta_f|``."""
    return (alpha * torch.sum(spec.weights.to(beta.dtype)
                              * group_norms(spec, beta))
            + weighted_l1(spec, beta))
