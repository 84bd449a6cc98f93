"""SGL-regularised structured sparsification of LM weights (PyTorch port of
``repro.sparsity.group_reg``).

Weight matrices are partitioned into structural groups (attention heads, FFN
channels); training applies the SGL penalty through its exact two-level
prox, and TLFre screening of the linearised local subproblem certifies
inactive groups.  The leaves are the stacked ones (``(R, ...)``), so a group
spans every copy of its layer: ``n_per`` counts the stack axis.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import GroupSpec, shrink


@dataclasses.dataclass(frozen=True)
class WeightGroups:
    """How one weight leaf decomposes into prunable groups.

    ``axis`` is the group axis (e.g. the head axis of wq, the channel axis of
    w_in); slices along it are the groups of an SGL problem whose features
    are the individual weights.
    """
    path: str
    axis: int
    n_groups: int


def head_groups_for(cfg) -> list[WeightGroups]:
    """Default grouping: attention heads + FFN channels per stacked block."""
    out = []
    if cfg.mla:
        out.append(WeightGroups("attn/wk_b", 2, cfg.num_heads))
    else:
        out.append(WeightGroups("attn/wq", 2, cfg.num_heads))
    if cfg.num_experts:
        out.append(WeightGroups("ffn/w_in", 1, cfg.num_experts))
    else:
        out.append(WeightGroups("ffn/w_in", 2, min(cfg.d_ff, 4096)))
    return out


def _other_axes(w: torch.Tensor, axis: int) -> tuple:
    return tuple(i for i in range(w.ndim) if i != axis)


def leaf_group_norms(w: torch.Tensor, axis: int) -> torch.Tensor:
    """L2 norm of each group slice, in float32."""
    return torch.sqrt(torch.sum(w.to(torch.float32) ** 2,
                                dim=_other_axes(w, axis)))


def sgl_weight_penalty(w: torch.Tensor, axis: int, lam1, lam2) -> torch.Tensor:
    """alpha-weighted SGL penalty of one weight leaf."""
    n_per = w.numel() // w.shape[axis]
    gn = leaf_group_norms(w, axis)
    return lam1 * float(n_per) ** 0.5 * torch.sum(gn) \
        + lam2 * torch.sum(torch.abs(w))


def sgl_weight_prox(w: torch.Tensor, axis: int, t_lam1, t_lam2, *,
                    n_per=None, sum_partial=None) -> torch.Tensor:
    """Exact SGL prox applied group-wise along ``axis`` (soft-threshold then
    group soft-threshold) — the closed form of ``core.prox.sgl_prox``.
    On a block of a sharded leaf, ``n_per`` is the full leaf's size of a
    group and ``sum_partial`` sums the groups' partial squares over the
    ranks that hold the rest of each group."""
    if n_per is None:
        n_per = w.numel() // w.shape[axis]
    u = shrink(w.to(torch.float32), t_lam2)
    sq = torch.sum(u * u, dim=_other_axes(w, axis), keepdim=True)
    gn = torch.sqrt(sq if sum_partial is None else sum_partial(sq))
    tg = t_lam1 * float(n_per) ** 0.5
    scale = torch.where(gn > tg, 1.0 - tg / torch.where(gn > 0, gn, 1.0), 0.0)
    return (u * scale).to(w.dtype)


def screen_weight_groups(acts: torch.Tensor, resid: torch.Tensor,
                         spec: GroupSpec, alpha, lam, lam_bar, theta_bar):
    """TLFre layer-1 on the linearised subproblem  min 0.5||resid - acts b||^2
    + SGL(b):  certify weight groups that stay zero.  ``acts``: (samples,
    features) local activation matrix; reuses the exact core machinery."""
    from ..core import (column_norms, estimate_dual_ball,
                        group_frobenius_norms, lambda_max_sgl,
                        normal_vector_sgl, tlfre_screen)
    lam_max, g_star = lambda_max_sgl(spec, acts.T @ resid, alpha)
    n_vec = normal_vector_sgl(acts, resid, spec, lam_bar, lam_max, theta_bar,
                              g_star)
    ball = estimate_dual_ball(resid, lam, lam_bar, theta_bar, n_vec)
    return tlfre_screen(acts, spec, alpha, ball, column_norms(acts),
                        group_frobenius_norms(acts, spec), safety=1e-6)


def apply_group_mask(w: torch.Tensor, axis: int, keep: torch.Tensor):
    """Zero out (freeze) pruned groups."""
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    return w * keep.reshape(shape).to(w.dtype)


def group_sparsity_stats(w: torch.Tensor, axis: int, tol=1e-8):
    gn = leaf_group_norms(w, axis)
    return {"groups": int(gn.numel()),
            "inactive": int(torch.sum(gn <= tol)),
            "weight_sparsity": float(torch.mean(
                (torch.abs(w) <= tol).to(torch.float32)))}
