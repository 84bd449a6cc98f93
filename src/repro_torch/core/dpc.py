"""DPC screening for the nonnegative Lasso (paper Section 5), PyTorch port.

Dual feasible set F = { theta : <x_i, theta> <= 1 } (Thm 19).  Theorem 20
gives lambda_max = max_i <x_i, y> (signed, not the absolute value),
Theorem 21 the normal-cone dual ball, Theorem 22 the DPC rule (one ball:
``dpc_screen``; a whole grid: ``dpc_screen_grid``):

    <x_i, o> + r * ||x_i|| < 1   =>   beta_i* = 0.

The feature-sharded screens (``_feat``) run the same rules block by block
over a column partition (``distributed.feature_shard``).
"""
from __future__ import annotations

import torch

from .estimation import DualBall, estimate_dual_ball
from .screening import (_require_f32_for_pallas, _xtv, grid_ball_geometry,
                        grid_ball_geometry_folds)


def lambda_max_nn(xty: torch.Tensor):
    """(lambda_max, argmax feature), both 0-d tensors — Theorem 20(iv)."""
    return torch.max(xty), torch.argmax(xty)


def nn_dual_feasible(xt_theta: torch.Tensor, tol: float = 0.0):
    return torch.all(xt_theta <= 1.0 + tol)


def nn_dual_objective(y, theta, lam):
    d = y - lam * theta
    return 0.5 * torch.dot(y, y) - 0.5 * torch.dot(d, d)


def nn_primal_objective(X, y, beta, lam):
    r = y - X @ beta
    return 0.5 * torch.dot(r, r) + lam * torch.sum(beta)  # beta >= 0: l1 = sum


def normal_vector_nn(X, y, lam_bar: float, lam_max: float, theta_bar,
                     i_star) -> torch.Tensor:
    """n(lam_bar) of Theorem 21: x_* at lam_max, else y/lam_bar - theta_bar.
    ``lam_bar`` and ``lam_max`` are host floats, so only the branch taken
    is computed."""
    if float(lam_bar) >= float(lam_max) * (1.0 - 1e-12):
        return X[:, int(i_star)]
    return y / lam_bar - theta_bar


def dpc_screen(X, ball: DualBall, col_norms, safety: float = 0.0, *,
               use_kernels: bool = False):
    """Theorem 22 for one dual ball.  Returns feat_keep (p,) bool: False =>
    certified zero.  ``use_kernels`` runs the GEMV ``X^T center`` through
    ``xtv`` (float32: a float64 input raises ``TypeError``); the ``>= 1``
    test stays plain."""
    r = ball.radius * (1.0 + safety)
    c = _xtv(X, ball.center, use_kernels).to(X.dtype)
    return c + r * col_norms >= 1.0


def estimate_dual_ball_nn(y, lam, lam_bar, theta_bar, n_vec) -> DualBall:
    """Theorem 21(ii): the algebra of Theorem 12(ii)."""
    return estimate_dual_ball(y, lam, lam_bar, theta_bar, n_vec)


def dpc_screen_grid(X, y, lambdas, theta_bar, n_vec, col_norms,
                    safety: float = 0.0):
    """Theorem 22 for a WHOLE remaining lambda grid in one GEMM.

    Same center/radius algebra as the SGL grid rule (Theorem 21 shares the
    Theorem-12 geometry); returns (feat_keep (L, p), radii (L,))."""
    centers, radii = grid_ball_geometry(y, lambdas, theta_bar, n_vec)
    radii = radii * (1.0 + safety)
    omega = centers @ X + radii[:, None] * col_norms[None, :]
    return omega >= 1.0, radii


def dpc_screen_grid_folds(X, Y, lambdas, Theta_bar, N_vecs, col_norms_f,
                          safety: float = 0.0, use_kernels: bool = False):
    """Fold-batched Theorem 22: K folds x L lambdas in ONE GEMM.

    Per-fold vectors are (K, N) with held-out rows zeroed, ``lambdas`` is
    (K, L), ``col_norms_f`` (K, p).  ``use_kernels`` runs the threshold
    ``C + r ||x_i|| >= 1`` through the fused ``dpc_screen_folds`` kernel
    (float32 only: a float64 input raises ``TypeError``).
    Returns (feat_keep (K, L, p), radii (K, L))."""
    K, L = lambdas.shape
    N = Y.shape[1]
    centers, radii = grid_ball_geometry_folds(Y, lambdas, Theta_bar, N_vecs)
    radii = radii * (1.0 + safety)
    C = (centers.reshape(K * L, N) @ X).reshape(K, L, X.shape[1])
    return _dpc_rule_folds(C, radii, col_norms_f, use_kernels), radii


def _dpc_rule_folds(C, radii, col_norms_f, use_kernels: bool):
    """The threshold ``C + r ||x_i|| >= 1`` on a (K, L, p) stack: through
    the fused ``dpc_screen_folds`` kernel with ``use_kernels``."""
    if use_kernels:
        _require_f32_for_pallas(C.dtype)
        from ..kernels import ops as _kops
        return _kops.dpc_screen_folds(
            C.to(torch.float32), radii.to(torch.float32).contiguous(),
            col_norms_f.to(torch.float32).contiguous())
    return C + radii[:, :, None] * col_norms_f[:, None, :] >= 1.0


def gap_safe_screen_grid_nn(c_theta, radii, col_norms):
    """Gap-Safe DPC grid rules for a fixed feasible center: one GEMV, radii
    vary per lambda.  Returns feat_keep (L, p)."""
    omega = c_theta[None, :] + radii[:, None] * col_norms[None, :]
    return omega >= 1.0


# ---------------------------------------------------------------------------
# Feature-sharded Theorem-22 screens (see core.screening for the SGL
# counterparts and distributed.feature_shard for the executor and layout).
# The threshold is per column, so the sharded rule is the unsharded rule on
# each block; pad columns give omega = 0 < 1 and are never kept.
# ---------------------------------------------------------------------------

def dpc_screen_grid_feat(ops, Xs, y, lambdas, theta_bar, n_vec,
                         col_norms_s, safety: float = 0.0):
    """Sharded ``dpc_screen_grid``: returns (feat_keep (n_local, L,
    p_shard), radii (L,))."""
    centers, radii = grid_ball_geometry(y, lambdas, theta_bar, n_vec)
    radii = radii * (1.0 + safety)

    def body(loc, centers, radii):
        Xb, cn = loc
        return centers @ Xb + radii[:, None] * cn[None, :] >= 1.0

    return ops.fmap(body, (Xs, col_norms_s), centers, radii), radii


def dpc_screen_grid_folds_feat(ops, Xs, Y, lambdas, Theta_bar, N_vecs,
                               col_norms_sf, safety: float = 0.0,
                               use_kernels: bool = False):
    """Sharded ``dpc_screen_grid_folds``; ``use_kernels`` runs each block's
    threshold through one ``dpc_screen_folds`` launch.  Returns (feat_keep
    (n_local, K, L, p_shard), radii (K, L))."""
    K, L = lambdas.shape
    N = Y.shape[1]
    centers, radii = grid_ball_geometry_folds(Y, lambdas, Theta_bar, N_vecs)
    radii = radii * (1.0 + safety)

    def body(loc, centers, radii):
        Xb, cn = loc
        C = (centers.reshape(K * L, N) @ Xb).reshape(K, L, Xb.shape[1])
        return _dpc_rule_folds(C, radii, cn, use_kernels)

    return ops.fmap(body, (Xs, col_norms_sf), centers, radii), radii


def gap_safe_screen_grid_nn_feat(ops, c_theta_s, radii, col_norms_s):
    """Sharded ``gap_safe_screen_grid_nn``: stacked fixed center
    ``c_theta_s`` (n_local, p_shard).  Returns feat_keep (n_local, L,
    p_shard)."""
    def body(loc, radii):
        ct, cn = loc
        return gap_safe_screen_grid_nn(ct, radii, cn)

    return ops.fmap(body, (c_theta_s, col_norms_s), radii)


def dual_scaling_nn(xt_rho: torch.Tensor) -> torch.Tensor:
    """Largest s in (0, 1] with s * rho dual-feasible for (82)."""
    m = torch.max(xt_rho)
    return torch.where(m > 1.0, 1.0 / m, torch.ones_like(m))
