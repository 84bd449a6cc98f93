"""TLFre: the two-layer screening rules (paper Theorems 15, 16, 17), PyTorch
port: the one-ball screen of the per-lambda driver (``tlfre_screen``) and
the grid form the path engine runs.

Layer 1 (group):    s_g* < alpha*w_g                        => beta_g* = 0
Layer 2 (feature):  |x_i^T o| + r*||x_i||_2 <= 1            => beta_i* = 0

where ``o``/``r`` are the Theorem-12 dual-ball center/radius (or the
beyond-paper Gap-Safe ball) and s_g* is the closed-form sup of Theorem 15:

    ||c||_inf >= 1 :  s* = ||S_1(c)|| + r
    ||c||_inf <  1 :  s* = (||c||_inf + r - 1)_+

With adaptive per-feature weights ``w`` the exact sup has no weighted
closed form; ``S_w`` is 1-Lipschitz, so ``||S_w(c)|| + r`` is a safe
(conservative) sup and the feature threshold becomes ``w_i``.  The weighted
rules run no kernel: ``screen_norms`` takes one l1 threshold.
"""
from __future__ import annotations

import dataclasses

import torch

from .estimation import DualBall, project_out_normal
from .fenchel import shrink
from .groups import GroupSpec, broadcast_to_features, group_sum
from .losses import SQUARED


@dataclasses.dataclass(frozen=True)
class ScreenResult:
    group_keep: torch.Tensor   # (G,) bool: False => group certified zero (L1)
    feat_keep: torch.Tensor    # (p,) bool: False => feature certified zero
    s_sup: torch.Tensor        # (G,) the Theorem-15 sup values
    t_sup: torch.Tensor        # (p,) the Theorem-16 sup values


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


def _xtv(X, v, use_kernels: bool):
    """``X^T v``: through the ``xtv`` kernel with ``use_kernels`` (float32;
    a float64 input raises ``TypeError``), else a plain product."""
    if use_kernels:
        _require_f32_for_pallas(X.dtype)
        from ..kernels import ops as _kops
        return _kops.xtv(X, v)
    return X.T @ v


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
    c_norm = torch.sqrt(group_sum(spec, shr * shr))
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


def _weighted_shrink_norms(spec: GroupSpec, C: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """``||S_w(C_g)||`` per row and group: (R, p) -> (R, G)."""
    shr = shrink(C, w[None, :])
    return torch.sqrt(group_sum(spec, shr * shr))


def _grid_rules(spec: GroupSpec, alpha, C, radii, col_norms, group_specnorms,
                use_kernels: bool = False):
    """Theorems 15/16 evaluated for every (lambda, group/feature) pair.
    ``C`` is (L, p), or (1, p) for one center shared by the grid's L
    radii.  Returns (group_keep (L, G), feat_keep (L, p), s (L, G), t (L,
    p)), ``s`` and ``t`` the Theorem-15/16 sups."""
    r_g = radii[:, None] * group_specnorms[None, :]
    if spec.feature_weights is None:
        c_norm, c_inf = _grid_group_stats(spec, C, use_kernels)
        s = sup_shrink_norm(c_norm, c_inf, r_g)
        thresh = 1.0
    else:
        w = spec.feature_weights.to(C.dtype)
        s = _weighted_shrink_norms(spec, C, w) + r_g
        thresh = w[None, :]
    group_keep = s >= alpha * spec.weights[None, :]    # compared in float64
    t = torch.abs(C) + radii[:, None] * col_norms[None, :]
    feat_keep = (t > thresh) & group_keep[:, spec.group_ids]
    return group_keep, feat_keep, s, t


def tlfre_screen(X, spec: GroupSpec, alpha, ball: DualBall,
                 col_norms: torch.Tensor, group_specnorms: torch.Tensor,
                 safety: float = 0.0, *,
                 use_kernels: bool = False) -> ScreenResult:
    """Apply (L1) and (L2) given one dual ball: the grid rules on the (1,
    p) row ``X^T center`` with L = 1.

    ``col_norms``: (p,) column l2 norms of X; ``group_specnorms``: (G,)
    ``||X_g||_2``.  ``safety`` inflates the radius multiplicatively (a few
    ULPs in float32; exactness runs use 0 in float64).  ``use_kernels``
    runs the screening GEMV through ``xtv`` and, without feature weights,
    the group statistics through one ``screen_norms`` launch (float32: a
    float64 input raises ``TypeError``).  With adaptive feature weights the
    sup is the conservative ``||S_w(c)|| + r`` and the feature test ``t >
    w``."""
    r = (ball.radius * (1.0 + safety)).reshape(1)
    c = _xtv(X, ball.center, use_kernels).to(X.dtype)  # the screening GEMV
    group_keep, feat_keep, s, t = _grid_rules(
        spec, alpha, c[None, :], r, col_norms, group_specnorms, use_kernels)
    return ScreenResult(group_keep[0], feat_keep[0], s[0], t[0])


def screen_stats(spec: GroupSpec, res: ScreenResult):
    """(#groups discarded, #features discarded by L1, #extra features
    discarded by L2)."""
    in_kept = broadcast_to_features(spec, res.group_keep)
    return (torch.sum(~res.group_keep), torch.sum(~in_kept),
            torch.sum(~res.feat_keep & in_kept))


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
    ``C`` (K, L, p), or (K, 1, p) for one center per fold shared by its
    grid, ``radii`` (K, L), per-fold norms (K, p) / (K, G).  Adaptive
    weights take the conservative bound of ``_grid_rules``."""
    K, L, p = C.shape
    r_g = radii[:, :, None] * group_specnorms_f[:, None, :]
    t = torch.abs(C) + radii[:, :, None] * col_norms_f[:, None, :]
    if spec.feature_weights is None:
        c_norm, c_inf = _grid_group_stats_folds(spec, C, use_kernels)
        s = sup_shrink_norm(c_norm, c_inf, r_g)
        thresh = 1.0
    else:
        w = spec.feature_weights.to(C.dtype)
        s = _weighted_shrink_norms(spec, C.reshape(K * L, p), w).reshape(
            K, L, spec.num_groups) + r_g
        thresh = w[None, None, :]
    group_keep = s >= alpha * spec.weights[None, None, :]
    feat_keep = (t > thresh) & group_keep[:, :, spec.group_ids]
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
    group_keep, feat_keep, _, _ = _grid_rules(
        spec, alpha, C, radii, col_norms, group_specnorms, use_kernels)
    return group_keep, feat_keep, radii


# ---------------------------------------------------------------------------
# Gap-Safe grid rules (beyond the paper): a fixed feasible dual center
# ---------------------------------------------------------------------------

def gap_safe_screen_grid(spec: GroupSpec, alpha, c_theta, radii, col_norms,
                         group_specnorms, use_kernels: bool = False):
    """Gap-Safe grid rules for a FIXED feasible dual center theta.

    SGL dual feasibility does not depend on lambda, so one feasible theta
    (the exact dual at the previous solved point) certifies a ball at
    every remaining lambda with radius sqrt(2*gap_l)/lam_l; the screening
    GEMM collapses to the GEMV ``c_theta = X^T theta``.  The reference
    runs the rules on ``c_theta`` broadcast to (L, p); here ``_grid_rules``
    takes the (1, p) row, so the group statistics are evaluated once
    (through ``screen_norms`` with ``use_kernels``) and broadcast across
    the grid: the same answers, without L copies of the row.  Returns
    (group_keep (L, G), feat_keep (L, p))."""
    return _grid_rules(spec, alpha, c_theta[None, :], radii, col_norms,
                       group_specnorms, use_kernels)[:2]


def gap_safe_screen_grid_folds(spec: GroupSpec, alpha, c_thetas, radii,
                               col_norms_f, group_specnorms_f,
                               use_kernels: bool = False):
    """Fold-batched Gap-Safe grid rules: per-fold fixed centers
    ``c_thetas`` (K, p), per-(fold, lambda) radii (K, L).  The group
    statistics are evaluated once per fold on the (K, 1, p) layout (one
    ``screen_norms_folds`` launch with ``use_kernels``) and broadcast
    across the grid.  Returns (group_keep (K, L, G), feat_keep (K, L,
    p))."""
    return _grid_rules_folds(spec, alpha, c_thetas[:, None, :], radii,
                             col_norms_f, group_specnorms_f, use_kernels)


# ---------------------------------------------------------------------------
# Feature-sharded grid screens.
#
# Column-sharded counterparts of the grid screens above: ``ops`` is a
# ``distributed.feature_shard.FeatureOps`` executor, ``Xs`` the local
# ``(N, p_shard)`` blocks, ``specs`` their local GroupSpecs, and the
# per-block norms carry a leading block axis.  The ball geometry (an
# N-space computation) stays replicated; the GEMM and the Theorem-15/16
# rules run block by block and fire no collective.  Pad columns are inert
# (see ``distributed.feature_shard``), so the stacked keep masks gather back
# to the single-device masks.  ``use_kernels`` runs each block's group
# statistics through the kernel of the unsharded screen (``screen_norms``,
# or ``screen_norms_folds`` for the fold stack): one launch a block.
# ---------------------------------------------------------------------------

def tlfre_screen_grid_feat(ops, Xs, specs, y, alpha, lambdas, theta_bar,
                           n_vec, col_norms_s, group_specnorms_s,
                           safety: float = 0.0, use_kernels: bool = False):
    """Sharded ``tlfre_screen_grid``: returns (group_keep (n_local, L,
    G_shard), feat_keep (n_local, L, p_shard), radii (L,))."""
    centers, radii = grid_ball_geometry(y, lambdas, theta_bar, n_vec)
    radii = radii * (1.0 + safety)

    def body(loc, centers, radii):
        Xb, spec_loc, cn, gs = loc
        return _grid_rules(spec_loc, alpha, centers @ Xb, radii, cn, gs,
                           use_kernels)[:2]

    group_keep_s, feat_keep_s = ops.fmap(
        body, (Xs, specs, col_norms_s, group_specnorms_s), centers, radii)
    return group_keep_s, feat_keep_s, radii


def gap_safe_screen_grid_feat(ops, specs, alpha, c_theta_s, radii,
                              col_norms_s, group_specnorms_s,
                              use_kernels: bool = False):
    """Sharded ``gap_safe_screen_grid``: the fixed center arrives stacked
    (``c_theta_s`` (n_local, p_shard), the certified duals the sharded
    sweep emits).  Returns (group_keep (n_local, L, G_shard), feat_keep
    (n_local, L, p_shard))."""
    def body(loc, radii):
        spec_loc, ct, cn, gs = loc
        return gap_safe_screen_grid(spec_loc, alpha, ct, radii, cn, gs,
                                    use_kernels)

    return ops.fmap(body, (specs, c_theta_s, col_norms_s,
                           group_specnorms_s), radii)


def tlfre_screen_grid_folds_feat(ops, Xs, specs, Y, alpha, lambdas,
                                 Theta_bar, N_vecs, col_norms_sf,
                                 group_specnorms_sf, safety: float = 0.0,
                                 mus_s=None, use_kernels: bool = False):
    """Sharded ``tlfre_screen_grid_folds``: per-fold norms stacked
    (n_local, K, p_shard) / (n_local, K, G_shard), ``mus_s`` the stacked
    per-fold column means of centered CV.  Returns (group_keep (n_local, K,
    L, G_shard), feat_keep (n_local, K, L, p_shard), radii (K, L))."""
    K, L = lambdas.shape
    N = Y.shape[1]
    centers, radii = grid_ball_geometry_folds(Y, lambdas, Theta_bar, N_vecs)
    radii = radii * (1.0 + safety)
    csum = centers.sum(dim=2)                                     # (K, L)

    def body(loc, centers, radii):
        Xb, spec_loc, cn, gs = loc[:4]
        C = (centers.reshape(K * L, N) @ Xb).reshape(K, L, Xb.shape[1])
        if mus_s is not None:
            C = C - csum[:, :, None] * loc[4][:, None, :]
        return _grid_rules_folds(spec_loc, alpha, C, radii, cn, gs,
                                 use_kernels)

    sharded = (Xs, specs, col_norms_sf, group_specnorms_sf)
    if mus_s is not None:
        sharded = sharded + (mus_s,)
    gk_s, fk_s = ops.fmap(body, sharded, centers, radii)
    return gk_s, fk_s, radii


def gap_safe_screen_grid_folds_feat(ops, specs, alpha, c_thetas_s, radii,
                                    col_norms_sf, group_specnorms_sf,
                                    use_kernels: bool = False):
    """Sharded ``gap_safe_screen_grid_folds``: stacked per-fold centers
    ``c_thetas_s`` (n_local, K, p_shard).  Returns (group_keep (n_local, K,
    L, G_shard), feat_keep (n_local, K, L, p_shard))."""
    def body(loc, radii):
        spec_loc, ct, cn, gs = loc
        return gap_safe_screen_grid_folds(spec_loc, alpha, ct, radii, cn,
                                          gs, use_kernels)

    return ops.fmap(body, (specs, c_thetas_s, col_norms_sf,
                           group_specnorms_sf), radii)


def gap_safe_grid_radii(y, lambdas, theta, resid, penalty):
    """sqrt(2 * gap_l) / lam_l per grid point, for a primal iterate beta
    with residual ``resid = y - X beta`` and penalty ``Omega(beta)`` (so
    P_l = 0.5||resid||^2 + lam_l * Omega) and a feasible dual theta: the
    squared loss through ``gap_safe_grid_radii_loss``, which gives the
    shapes (one path, or K folds)."""
    return gap_safe_grid_radii_loss(SQUARED, y, lambdas, theta, None, resid,
                                    penalty)


def gap_safe_grid_radii_loss(loss, y, lambdas, theta, fit, resid, penalty):
    """Loss-generic Gap-Safe grid radii: ``sqrt(2 * gamma * gap_l) /
    lam_l`` per grid point (the dual is ``lam^2/gamma``-strongly concave
    for a loss with smoothness constant ``gamma``).  ``fit = X beta``,
    ``resid = loss.residual(y, fit)``; ``theta`` must be dual-feasible.
    ``y``, ``theta``, ``resid`` (N,) with ``lambdas`` (L,) and a scalar
    ``penalty`` give (L,); the squared loss also takes K folds at once,
    (K, N) with (K, L) and (K,), and gives (K, L)."""
    penalty = torch.as_tensor(penalty, dtype=lambdas.dtype,
                              device=lambdas.device)
    p_smooth = loss.primal_value(y, fit, resid)
    dual = loss.dual_value(y[..., None, :], theta[..., None, :],
                           lambdas[..., None])
    gap = torch.clamp(p_smooth[..., None] + lambdas * penalty[..., None]
                      - dual, min=0.0)
    if loss.gamma != 1.0:
        gap = loss.gamma * gap
    return torch.sqrt(2.0 * gap) / lambdas
