"""TLFre: the two-layer screening rules (paper Theorems 15, 16, 17), PyTorch
port of the grid form the path engine runs.

Layer 1 (group):    s_g* < alpha*w_g                        => beta_g* = 0
Layer 2 (feature):  |x_i^T o| + r*||x_i||_2 <= 1            => beta_i* = 0

where ``o``/``r`` are the Theorem-12 dual-ball center/radius and s_g* is the
closed-form sup of Theorem 15:

    ||c||_inf >= 1 :  s* = ||S_1(c)|| + r
    ||c||_inf <  1 :  s* = (||c||_inf + r - 1)_+
"""
from __future__ import annotations

import torch

from .estimation import project_out_normal
from .fenchel import shrink
from .groups import GroupSpec


def sup_shrink_norm(c_shrink_norm, c_inf, r):
    """Theorem 15 closed form, branch-free."""
    return torch.where(c_inf >= 1.0, c_shrink_norm + r,
                       torch.clamp(c_inf + r - 1.0, min=0.0))


def _require_f32_for_pallas(dtype) -> None:
    """The CUDA kernels compute in float32; silently round-tripping a
    float64 exactness run through them would destroy the screening-rule
    proofs, so a float64 input with kernels requested raises."""
    if dtype == torch.float64:
        raise TypeError(
            "use_kernels=True would round-trip float64 screening statistics "
            "through the float32 CUDA kernels; float64 exactness runs must "
            "use the plain path (use_kernels=False)")


def _grid_group_stats(spec: GroupSpec, C: torch.Tensor, use_kernels: bool):
    """(||S_1(C_g)||, ||C_g||_inf) per grid row: (L, p) -> ((L, G), (L, G)).

    ``use_kernels`` routes the fused reduction through the ``screen_norms``
    kernel, which reads C through the spec's padded view, so the padded
    (L, G, n_max) copy of C never exists (float32 — callers must carry a
    nonzero ``safety`` inflation)."""
    if use_kernels:
        _require_f32_for_pallas(C.dtype)
        from ..kernels import ops as _kops
        snorm2, cinf = _kops.screen_norms_gather(C, spec.pad_index,
                                                 spec.pad_mask)
        return torch.sqrt(snorm2).to(C.dtype), cinf.to(C.dtype)
    L, G = C.shape[0], spec.num_groups
    shr = shrink(C)
    c_norm = torch.sqrt(torch.zeros((L, G), dtype=C.dtype, device=C.device)
                        .index_add_(1, spec.group_ids, shr * shr))
    # empty groups keep the -inf initial value, as jax.ops.segment_max does
    c_inf = torch.full((L, G), float("-inf"), dtype=C.dtype,
                       device=C.device).scatter_reduce_(
        1, spec.group_ids.expand(L, -1), torch.abs(C), "amax",
        include_self=True)
    return c_norm, c_inf


def _grid_group_stats_folds(spec: GroupSpec, C: torch.Tensor,
                            use_kernels: bool):
    """Fold-stacked group statistics: (K, L, p) -> ((K, L, G), (K, L, G)).

    ``use_kernels`` routes the whole (K*L, p) CV layout through ONE
    ``screen_norms_folds`` launch (float32, same float64 refusal as
    ``_grid_group_stats``); otherwise the plain segment reductions run on
    the (K*L, p) rows, which is the reference's vmap over folds."""
    K, L, p = C.shape
    if use_kernels:
        _require_f32_for_pallas(C.dtype)
        from ..kernels import ops as _kops
        c_pad = torch.where(spec.pad_mask[None, None],
                            C[:, :, spec.pad_index], 0.0)
        snorm2, cinf = _kops.screen_norms_folds(c_pad.to(torch.float32),
                                                spec.pad_mask)
        return torch.sqrt(snorm2).to(C.dtype), cinf.to(C.dtype)
    c_norm, c_inf = _grid_group_stats(spec, C.reshape(K * L, p), False)
    G = spec.num_groups
    return c_norm.reshape(K, L, G), c_inf.reshape(K, L, G)


def _grid_rules(spec: GroupSpec, alpha, C, radii, col_norms, group_specnorms,
                use_kernels: bool = False):
    """Theorems 15/16 evaluated for every (lambda, group/feature) pair."""
    if spec.feature_weights is not None:
        raise NotImplementedError(
            "adaptive feature weights are not ported yet (ROADMAP queue 1, "
            "item 8)")
    r_g = radii[:, None] * group_specnorms[None, :]
    c_norm, c_inf = _grid_group_stats(spec, C, use_kernels)
    s = sup_shrink_norm(c_norm, c_inf, r_g)
    group_keep = s >= alpha * spec.weights[None, :]    # compared in float64

    t = torch.abs(C) + radii[:, None] * col_norms[None, :]
    feat_keep = (t > 1.0) & group_keep[:, spec.group_ids]
    return group_keep, feat_keep


def grid_ball_geometry(y, lambdas, theta_bar, n_vec):
    """Theorem-12 ball centers/radii for a whole grid sharing (theta_bar, n).

    Returns (centers (L, N), radii (L,)) — the radii are NOT safety-inflated.
    """
    v = y[None, :] / lambdas[:, None] - theta_bar[None, :]        # (L, N)
    v_perp = project_out_normal(v, n_vec)
    centers = theta_bar[None, :] + 0.5 * v_perp
    radii = 0.5 * torch.linalg.vector_norm(v_perp, dim=1)
    return centers, radii


def grid_ball_geometry_folds(Y, lambdas, Theta_bar, N_vecs):
    """Theorem-12 ball geometry for K folds x L lambdas at once.

    Per-fold quantities live on the FULL row index with held-out rows
    zeroed (zero rows add nothing to any inner product, so the masked
    algebra is the per-fold algebra).  ``Y``/``Theta_bar``/``N_vecs``:
    (K, N); ``lambdas``: (K, L).  Returns (centers (K, L, N), radii (K, L))
    — the reference's vmap of ``grid_ball_geometry`` with the fold axis
    written out, including its zero-normal guard per fold."""
    v = Y[:, None, :] / lambdas[:, :, None] - Theta_bar[:, None, :]
    n2 = torch.sum(N_vecs * N_vecs, dim=1)                       # (K,)
    ok = n2 > 0
    coef = torch.where(ok[:, None],
                       torch.einsum("kln,kn->kl", v, N_vecs)
                       / torch.where(ok, n2, 1.0)[:, None], 0.0)
    v_perp = v - coef[:, :, None] * N_vecs[:, None, :]
    centers = Theta_bar[:, None, :] + 0.5 * v_perp
    radii = 0.5 * torch.linalg.vector_norm(v_perp, dim=2)
    return centers, radii


def _grid_rules_folds(spec: GroupSpec, alpha, C, radii, col_norms_f,
                      group_specnorms_f, use_kernels: bool = False):
    """Theorems 15/16 for every (fold, lambda, group/feature) triple.
    ``C`` (K, L, p), ``radii`` (K, L), per-fold norms (K, p) / (K, G)."""
    if spec.feature_weights is not None:
        raise NotImplementedError(
            "adaptive feature weights are not ported yet (ROADMAP queue 1, "
            "item 8)")
    r_g = radii[:, :, None] * group_specnorms_f[:, None, :]
    c_norm, c_inf = _grid_group_stats_folds(spec, C, use_kernels)
    s = sup_shrink_norm(c_norm, c_inf, r_g)
    group_keep = s >= alpha * spec.weights[None, None, :]

    t = torch.abs(C) + radii[:, :, None] * col_norms_f[:, None, :]
    feat_keep = (t > 1.0) & group_keep[:, :, spec.group_ids]
    return group_keep, feat_keep


def tlfre_screen_grid_folds(X, Y, spec: GroupSpec, alpha, lambdas, Theta_bar,
                            N_vecs, col_norms_f, group_specnorms_f,
                            safety: float = 0.0, mus=None,
                            use_kernels: bool = False):
    """Fold-batched TLFre grid screen: K folds x L lambdas in ONE
    ``(K*L, N) x (N, p)`` GEMM against the SHARED design (fold-k centers
    are zero on fold k's held-out rows).  ``mus`` (optional, (K, p)):
    per-fold train-row column means; fold k's centered design needs only
    the rank-one correction ``C -= sum(center) * mu_k``.  Returns
    (group_keep (K, L, G), feat_keep (K, L, p), radii (K, L))."""
    K, L = lambdas.shape
    N = Y.shape[1]
    centers, radii = grid_ball_geometry_folds(Y, lambdas, Theta_bar, N_vecs)
    radii = radii * (1.0 + safety)
    C = (centers.reshape(K * L, N) @ X).reshape(K, L, X.shape[1])
    if mus is not None:
        C = C - centers.sum(dim=2)[:, :, None] * mus[:, None, :]
    group_keep, feat_keep = _grid_rules_folds(spec, alpha, C, radii,
                                              col_norms_f, group_specnorms_f,
                                              use_kernels)
    return group_keep, feat_keep, radii


def tlfre_screen_grid(X, y, spec: GroupSpec, alpha, lambdas, lam_bar,
                      theta_bar, n_vec, col_norms, group_specnorms,
                      safety: float = 0.0, use_kernels: bool = False):
    """Evaluate the TLFre rules for a WHOLE remaining lambda grid at once.

    All grid points share theta_bar, so the L screening GEMVs stack into ONE
    (L, N) x (N, p) GEMM (a plain ``torch.matmul``; TF32 must be off, since
    the float32 ``safety`` margin assumes true float32 products).

    Returns (group_keep (L, G), feat_keep (L, p), radii (L,)).
    """
    centers, radii = grid_ball_geometry(y, lambdas, theta_bar, n_vec)
    radii = radii * (1.0 + safety)
    C = centers @ X                                                # (L, p)
    group_keep, feat_keep = _grid_rules(spec, alpha, C, radii, col_norms,
                                        group_specnorms, use_kernels)
    return group_keep, feat_keep, radii
