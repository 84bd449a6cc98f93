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
    kernel on the padded (L*G, n_max) layout (float32 — callers must carry a
    nonzero ``safety`` inflation)."""
    if use_kernels:
        _require_f32_for_pallas(C.dtype)
        from ..kernels import ops as _kops
        c_pad = torch.where(spec.pad_mask[None], C[:, spec.pad_index], 0.0)
        snorm2, cinf = _kops.screen_norms_batched(c_pad.to(torch.float32),
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
