"""Zero-solution parameter region (paper Theorem 8, Lemma 9), PyTorch port.

``rho_g`` is the root of the piecewise-quadratic equation

    || S_1( X_g^T y / rho ) ||^2  ==  (alpha * w_g)^2            (Lemma 9)

With ``z`` = |X_g^T y| sorted descending and ``rho`` in the segment
``(z_{k+1}, z_k]`` exactly the top-k entries are active:

    (k - T) rho^2 - 2 ||z^(k)||_1 rho + ||z^(k)||^2 = 0,   T = (alpha w_g)^2.

All segments are solved vectorised and the unique in-segment root selected.
Adaptive per-feature l1 weights ``w_i`` generalise the equation to
``sum_i (z_i/rho - w_i)_+^2 == T`` (``_padded_segment_roots_w``).
"""
from __future__ import annotations

import torch

from .fenchel import shrink
from .groups import GroupSpec, group_norms, pad_groups


def _padded_segment_roots(z: torch.Tensor,
                          target_sq: torch.Tensor) -> torch.Tensor:
    """Root of sum_i (z_i/rho - 1)_+^2 == target_sq per row.

    z: (G, n_max) nonnegative (invalid slots zero), target_sq: (G,).
    Returns rho >= 0; rho == 0 for all-zero rows (no constraint from them).
    """
    z = torch.sort(z, dim=1, descending=True).values   # zeros last
    cs1 = torch.cumsum(z, dim=1)                        # ||z^(k)||_1
    cs2 = torch.cumsum(z * z, dim=1)                    # ||z^(k)||^2
    n_max = z.shape[1]
    k = torch.arange(1, n_max + 1, dtype=z.dtype, device=z.device)

    a = k[None, :] - target_sq[:, None]
    b = -2.0 * cs1
    c = cs2
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    sq = torch.sqrt(disc)
    tiny = 1e-30
    safe_a = torch.where(torch.abs(a) > tiny, a, tiny)
    r_plus = (-b + sq) / (2.0 * safe_a)
    r_minus = (-b - sq) / (2.0 * safe_a)
    # a -> 0 degenerates to the linear equation -2*cs1*rho + cs2 = 0.
    r_lin = torch.where(cs1 > 0, cs2 / (2.0 * cs1), 0.0)
    # segment / degeneracy tolerances scale with the dtype: 1e-9 is far below
    # float32 rounding, where roots a few ULPs outside their segment would be
    # dropped (the unsafe direction)
    seg_tol = max(1e-9, 128.0 * torch.finfo(z.dtype).eps)
    lin = torch.abs(a) <= seg_tol * torch.maximum(
        k[None, :].expand_as(a), target_sq[:, None].expand_as(a))

    hi = z                                               # segment bound z_k
    lo = torch.cat([z[:, 1:], torch.zeros_like(z[:, :1])], dim=1)
    span = torch.clamp(hi[:, :1], min=1.0)
    eps = seg_tol * span

    def in_seg(r):
        return (r >= lo - eps) & (r <= hi + eps) & (r > 0)

    cand = torch.where(lin & in_seg(r_lin), r_lin, 0.0)
    cand = torch.maximum(cand, torch.where(~lin & in_seg(r_plus), r_plus, 0.0))
    cand = torch.maximum(cand,
                         torch.where(~lin & in_seg(r_minus), r_minus, 0.0))
    return torch.max(cand, dim=1).values


def _padded_segment_roots_w(z: torch.Tensor, w: torch.Tensor,
                            target_sq: torch.Tensor) -> torch.Tensor:
    """Adaptive-l1 generalisation: root of
    ``sum_i (z_i/rho - w_i)_+^2 == target_sq`` per row.

    z, w: (G, n_max) nonnegative (invalid slots zero in BOTH), target_sq:
    (G,).  Feature i is active iff ``z_i/w_i > rho``, so segments are
    ordered by the ratio; within segment k the equation is the quadratic

        (||w^(k)||^2 - T) rho^2 - 2 <z^(k), w^(k)> rho + ||z^(k)||^2 = 0

    which reduces to ``_padded_segment_roots`` when w == 1.  Padding slots
    carry w == 0 and z == 0, so they never contribute.
    """
    tiny = 1e-30
    ratio = torch.where(w > 0, z / torch.clamp(w, min=tiny), 0.0)
    order = torch.argsort(ratio, dim=1, descending=True, stable=True)
    zs = torch.gather(z, 1, order)
    ws = torch.gather(w, 1, order)
    rs = torch.gather(ratio, 1, order)
    cs_zw = torch.cumsum(zs * ws, dim=1)
    cs_z2 = torch.cumsum(zs * zs, dim=1)
    cs_w2 = torch.cumsum(ws * ws, dim=1)

    a = cs_w2 - target_sq[:, None]
    b = -2.0 * cs_zw
    c = cs_z2
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    sq = torch.sqrt(disc)
    safe_a = torch.where(torch.abs(a) > tiny, a, tiny)
    r_plus = (-b + sq) / (2.0 * safe_a)
    r_minus = (-b - sq) / (2.0 * safe_a)
    r_lin = torch.where(cs_zw > 0, cs_z2 / (2.0 * cs_zw), 0.0)
    seg_tol = max(1e-9, 128.0 * torch.finfo(z.dtype).eps)
    lin = torch.abs(a) <= seg_tol * torch.maximum(
        cs_w2, target_sq[:, None].expand_as(cs_w2))

    hi = rs                                              # bounds in rho
    lo = torch.cat([rs[:, 1:], torch.zeros_like(rs[:, :1])], dim=1)
    span = torch.clamp(hi[:, :1], min=1.0)
    eps = seg_tol * span

    def in_seg(r):
        return (r >= lo - eps) & (r <= hi + eps) & (r > 0)

    cand = torch.where(lin & in_seg(r_lin), r_lin, 0.0)
    cand = torch.maximum(cand, torch.where(~lin & in_seg(r_plus), r_plus, 0.0))
    cand = torch.maximum(cand,
                         torch.where(~lin & in_seg(r_minus), r_minus, 0.0))
    return torch.max(cand, dim=1).values


def group_shrink_roots(spec: GroupSpec, c: torch.Tensor,
                       alpha) -> torch.Tensor:
    """rho_g per group for c = X^T y (Lemma 9, weighted).  Shape (G,).
    The weights are float64 master data, cast to c's dtype."""
    z = pad_groups(spec, torch.abs(c))
    target_sq = (alpha * spec.weights.to(z.dtype)) ** 2
    if spec.feature_weights is None:
        return _padded_segment_roots(z, target_sq)
    w = pad_groups(spec, spec.feature_weights.to(z.dtype))
    return _padded_segment_roots_w(z, w, target_sq)


def lambda_max_sgl(spec: GroupSpec, xty: torch.Tensor, alpha):
    """(lambda_max^alpha, argmax group) for problem (3) (Theorem 8), both
    0-d tensors on xty's device."""
    rho = group_shrink_roots(spec, xty, alpha)
    return torch.max(rho), torch.argmax(rho)


def lambda1_max(spec: GroupSpec, xty: torch.Tensor, lam2):
    """Corollary 10(i): lambda1_max(lambda2) = max_g ||S_{lam2}(X_g^T y)||
    / w_g."""
    return torch.max(group_norms(spec, shrink(xty, lam2)) / spec.weights)


def lambda2_max(xty: torch.Tensor):
    """Corollary 10(ii): lambda2_max = ||X^T y||_inf."""
    return torch.max(torch.abs(xty))


def dual_scaling_sgl(spec: GroupSpec, c: torch.Tensor, alpha) -> torch.Tensor:
    """Largest s in (0, 1] such that s * rho is SGL-dual-feasible, where
    c = X^T rho:  s = min_g 1/rho_g over the Lemma-9 roots."""
    rho = group_shrink_roots(spec, c, alpha)
    s = torch.where(rho > 1.0, 1.0 / rho, 1.0)
    return torch.min(s)
