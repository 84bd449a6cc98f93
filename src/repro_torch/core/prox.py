"""Proximal operators for SGL and the nonnegative Lasso (PyTorch port).

The prox of t * (lam1 * sum_g w_g ||b_g|| + lam2 ||b||_1) is the exact
composition soft-threshold-then-group-soft-threshold (Friedman et al. 2010):

    u   = S_{t*lam2}(v)
    b_g = (1 - t*lam1*w_g / ||u_g||)_+  u_g
"""
from __future__ import annotations

import torch

from .fenchel import shrink
from .groups import GroupSpec, broadcast_to_features, group_norms


def sgl_prox(spec: GroupSpec, v: torch.Tensor, t_l1,
             t_group: torch.Tensor) -> torch.Tensor:
    """v: (p,);  t_l1 = t*lam2 scalar;  t_group = t*lam1*w_g, shape (G,)."""
    u = shrink(v, t_l1)
    norms = group_norms(spec, u)
    scale = torch.where(norms > t_group,
                        1.0 - t_group / torch.where(norms > 0, norms, 1.0),
                        0.0)
    return u * broadcast_to_features(spec, scale)


def nn_lasso_prox(v: torch.Tensor, t_lam) -> torch.Tensor:
    """prox of t*lam*||.||_1 + I_{R+}:  (v - t*lam)_+."""
    return torch.clamp(v - t_lam, min=0.0)
