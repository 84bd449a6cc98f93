"""Fenchel-dual machinery for SGL (paper Section 3), PyTorch port.

The shrinkage operator ``S_gamma`` (Eq. 1/19) and the closed-form
decomposition of any point of the summed dual set
``D_g = alpha*sqrt(n_g)*B2 + B_inf`` (Lemma 3 / Remark 2):

    xi = P_Binf(xi) + S_1(xi),    P_Binf(xi) in B_inf,  S_1(xi) in C_g

which turns the feasibility test of the Lagrangian dual (4) into the
explicit test ``||S_1(X_g^T theta)|| <= alpha*sqrt(n_g)`` of the Fenchel
dual (13); the primal and dual objectives of problem (3).
"""
from __future__ import annotations

import torch

from .groups import GroupSpec, group_max_abs, group_norms


def shrink(w: torch.Tensor, gamma=1.0) -> torch.Tensor:
    """Soft-threshold / shrinkage operator S_gamma (Eq. 1)."""
    return torch.sign(w) * torch.clamp(torch.abs(w) - gamma, min=0.0)


def proj_binf(w: torch.Tensor, gamma=1.0) -> torch.Tensor:
    """Projection onto the l_inf ball of radius gamma."""
    return torch.clamp(w, min=-gamma, max=gamma)


def dual_decompose(xi: torch.Tensor, gamma=1.0):
    """Decompose xi in gamma*B_inf + C as (P_Binf, S_gamma) (Remark 2).
    ``xi == proj + shr`` holds for EVERY xi (Eq. 19); membership of the
    shrunk part in C_g is what feasibility checks."""
    return proj_binf(xi, gamma), shrink(xi, gamma)


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


def sgl_dual_objective(y: torch.Tensor, theta: torch.Tensor, lam):
    """Dual objective of (4): 0.5||y||^2 - 0.5*lam^2*||y/lam - theta||^2."""
    d = y - lam * theta
    return 0.5 * torch.dot(y, y) - 0.5 * torch.dot(d, d)


def sgl_primal_objective(X, y, beta, spec: GroupSpec, lam, alpha):
    """Objective of problem (3)."""
    r = y - X @ beta
    return 0.5 * torch.dot(r, r) + lam * sgl_penalty(spec, beta, alpha)


def group_inf_norms(spec: GroupSpec, x: torch.Tensor) -> torch.Tensor:
    return group_max_abs(spec, x)
