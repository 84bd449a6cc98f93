"""TLFre certification of LM weight groups (PyTorch port of
``repro.sparsity.prune``).

Groups that the prox has driven to zero during SGL-regularised training are
only *empirically* zero.  This module runs the paper's layer-1 rule on the
linearised local subproblem

    min_b 0.5 || r - A b ||^2 + lam (alpha sum_g w_g ||b_g|| + ||b||_1)

with A a batch of layer-input activations and r the residual target, and
certifies which groups are provably zero at the optimum; those are frozen
(masked).
"""
from __future__ import annotations

import torch

from ..core import (GroupSpec, column_norms, estimate_dual_ball,
                    group_frobenius_norms, lambda_max_sgl, normal_vector_sgl,
                    tlfre_screen)
from . import group_reg


def certify_inactive_groups(acts: torch.Tensor, resid: torch.Tensor,
                            spec: GroupSpec, alpha: float, lam: float,
                            safety: float = 1e-6):
    """Run TLFre (layer 1+2) on the linearised subproblem from lam_max down
    to ``lam`` in one jump.  Returns a ScreenResult; ``~res.group_keep``
    are the groups certified zero at ``lam``."""
    xty = acts.T @ resid
    lam_max, g_star = lambda_max_sgl(spec, xty, alpha)
    lam_max_f = torch.clamp(lam_max, min=lam)
    theta_bar = resid / lam_max_f
    n_vec = normal_vector_sgl(acts, resid, spec, lam_max_f, lam_max_f,
                              theta_bar, g_star)
    ball = estimate_dual_ball(resid, lam, lam_max_f, theta_bar, n_vec)
    return tlfre_screen(acts, spec, alpha, ball, column_norms(acts),
                        group_frobenius_norms(acts, spec), safety=safety)


def prune_step(w: torch.Tensor, axis: int, acts: torch.Tensor,
               resid: torch.Tensor, alpha: float, lam: float):
    """Certify + freeze one weight leaf's groups.  ``acts``: (samples,
    n_groups) group-aggregated activations (one feature per group for the
    group-level rule).  Returns (masked weight, keep mask, #pruned)."""
    spec = GroupSpec.uniform_groups(acts.shape[1], 1, device=acts.device)
    res = certify_inactive_groups(acts, resid, spec, alpha, lam)
    keep = res.group_keep
    w_new = group_reg.apply_group_mask(w, axis, keep.to(w.device))
    return w_new, keep, int(torch.sum(~keep))
