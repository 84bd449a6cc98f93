"""Dual-optimum estimation via normal cones (paper Theorem 12), PyTorch port.

Given the exact dual optimum ``theta_bar`` at a previous path point
``lam_bar <= lam_max`` and a normal-cone direction ``n`` at it, the dual
optimum at lam < lam_bar lies in the ball

    || theta*(lam) - (theta_bar + v_perp/2) || <= ||v_perp|| / 2

with v = y/lam - theta_bar and v_perp its component orthogonal to n.
"""
from __future__ import annotations

import dataclasses

import torch

from .fenchel import shrink
from .groups import GroupSpec, broadcast_to_features


@dataclasses.dataclass(frozen=True)
class DualBall:
    """Ball certified to contain the dual optimum."""
    center: torch.Tensor   # (N,)
    radius: torch.Tensor   # 0-d


def project_out_normal(v, n_vec):
    """``v_perp``: the component of ``v`` orthogonal to ``n_vec``.

    Zero-normal guard: when ``n_vec == 0`` (or its squared norm underflows)
    the constraint is vacuous and ``v_perp = v`` exactly — no NaN.  ``v`` may
    be (N,) or batched (..., N) against a single (N,) normal.
    """
    n2 = torch.dot(n_vec, n_vec)
    coef = torch.where(n2 > 0, (v @ n_vec) / torch.where(n2 > 0, n2, 1.0),
                       0.0)
    return v - coef[..., None] * n_vec if v.ndim > 1 else v - coef * n_vec


def normal_vector_sgl(X, y, spec: GroupSpec, lam_bar: float, lam_max: float,
                      theta_bar, g_star) -> torch.Tensor:
    """n_alpha(lam_bar) of Theorem 12.

    * lam_bar <  lam_max:  y/lam_bar - theta_bar     (Prop. 11(iii))
    * lam_bar == lam_max:  X_* S_1(X_*^T y/lam_max)  (the active-group normal)

    ``lam_bar`` and ``lam_max`` are host floats, so only the branch taken
    is computed.
    """
    if float(lam_bar) >= float(lam_max) * (1.0 - 1e-12):
        w = shrink(X.T @ (y / lam_max))
        gids = torch.arange(spec.num_groups, device=X.device)
        w_star = torch.where(broadcast_to_features(spec, gids) == g_star,
                             w, 0.0)
        return X @ w_star
    return y / lam_bar - theta_bar


def estimate_dual_ball(y, lam, lam_bar, theta_bar, n_vec) -> DualBall:
    """Theorem 12(ii) (identical algebra for Theorem 21)."""
    v = y / lam - theta_bar
    v_perp = project_out_normal(v, n_vec)
    return DualBall(center=theta_bar + 0.5 * v_perp,
                    radius=0.5 * torch.linalg.vector_norm(v_perp))


def gap_safe_ball(theta_feasible, primal_value, dual_value, lam,
                  gamma: float = 1.0) -> DualBall:
    """Beyond the paper: the Gap-Safe ball (Fercoq et al., 2015).  For a
    loss with smoothness constant ``gamma`` (1 squared, 1/4 logistic) the
    dual is ``lam^2/gamma``-strongly concave, so

        ||theta* - theta|| <= sqrt(2 * gamma * gap) / lam .

    The scaling is applied only for ``gamma != 1.0``, as in the
    reference."""
    gap = torch.clamp(torch.as_tensor(primal_value - dual_value), min=0.0)
    if gamma != 1.0:
        gap = gamma * gap
    return DualBall(center=theta_feasible, radius=torch.sqrt(2.0 * gap) / lam)
