"""FISTA for SGL (3) and the nonnegative Lasso (80), PyTorch port, with
duality-gap stopping.

The dual point used in the gap is the residual scaled onto the feasible set
with the Lemma-9 root machinery (``lambda_max.dual_scaling_sgl``), so the
reported gaps are true optimality certificates.

The reference's ``lax.while_loop`` over ``lax.scan`` chunks becomes a Python
loop over device tensors: ``check_every`` iterations run without a host
read, then the gap is computed and read on the host once.  Iteration counts
therefore match the reference's (multiples of ``check_every``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import dpc as _dpc
from .fenchel import sgl_penalty
from .groups import GroupSpec
from .lambda_max import dual_scaling_sgl
from .losses import SQUARED
from .prox import nn_lasso_prox, sgl_prox


class SolveResult(NamedTuple):
    beta: torch.Tensor
    theta: torch.Tensor         # feasible dual point (y - X beta)/lam, scaled
    gap: torch.Tensor
    iters: int


def _sgl_gap(X, y, spec, lam, alpha, beta, loss=SQUARED):
    """(primal, dual, theta_feasible) at beta."""
    fit = X @ beta
    resid = loss.residual(y, fit)
    rho = resid / lam
    s = dual_scaling_sgl(spec, X.T @ rho, alpha)
    theta = s * rho
    p = loss.primal_value(y, fit, resid) + lam * sgl_penalty(spec, beta, alpha)
    d = loss.dual_value(y, theta, lam)
    return p, d, theta


def fista_sgl(X, y, spec: GroupSpec, lam, alpha, lipschitz, beta0, *,
              max_iter: int = 20000, check_every: int = 10, tol: float = 1e-9,
              prox=None, loss=SQUARED) -> SolveResult:
    """FISTA with O'Donoghue-Candes adaptive restart for problem (3).

    ``lam`` and ``lipschitz`` (the design bound ``||X||^2``) are scalars or
    0-d tensors.  ``prox`` optionally overrides the
    ``(z, t_l1, t_group) -> z'`` proximal step — the engine injects the
    fused CUDA kernel here; ``t_l1`` reaches it as a 1-element device
    tensor.  The gap is read on the host once every ``check_every``
    iterations and tested against ``tol * gap_scale``.
    """
    dtype, dev = X.dtype, X.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    lipschitz = torch.as_tensor(lipschitz, dtype=dtype, device=dev)
    beta0 = beta0.to(dtype)
    tol = loss.effective_tol(tol, dtype)
    t_step = 1.0 / lipschitz
    t_l1 = (t_step * lam).reshape(1)               # lam2 = lam
    t_group = t_step * lam * alpha * spec.weights.to(dtype)
    threshold = tol * loss.gap_scale(y)
    if prox is None:
        prox = lambda v, a, b: sgl_prox(spec, v, a, b)   # noqa: E731

    beta, z = beta0, beta0
    tk = torch.ones((), dtype=dtype, device=dev)
    it = 0
    gap = torch.full((), float("inf"), dtype=dtype, device=dev)
    theta = None
    while it < max_iter and bool(gap > threshold):
        for _ in range(check_every):
            g = X.T @ loss.grad(y, X @ z)
            beta_new = prox(z - t_step * g, t_l1, t_group).to(dtype)
            # adaptive restart: reset momentum when the extrapolated
            # direction opposes progress
            restart = torch.dot(z - beta_new, beta_new - beta) > 0
            tk = torch.where(restart, 1.0, tk)
            tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
            z = beta_new + ((tk - 1.0) / tk1) * (beta_new - beta)
            beta, tk = beta_new, tk1
        pval, dval, theta = _sgl_gap(X, y, spec, lam, alpha, beta, loss)
        it += check_every
        gap = (pval - dval).to(dtype)
    if theta is None:                   # max_iter <= 0: no check ran
        _, _, theta = _sgl_gap(X, y, spec, lam, alpha, beta, loss)
    return SolveResult(beta, theta, gap, it)


# ---------------------------------------------------------------------------
# Nonnegative Lasso
# ---------------------------------------------------------------------------

def _nn_gap(X, y, lam, beta):
    """(primal, dual, theta_feasible) at beta for problem (80)."""
    rho = (y - X @ beta) / lam
    s = _dpc.dual_scaling_nn(X.T @ rho)
    theta = s * rho
    p = _dpc.nn_primal_objective(X, y, beta, lam)
    d = _dpc.nn_dual_objective(y, theta, lam)
    return p, d, theta


def fista_nn_lasso(X, y, lam, lipschitz, beta0, *, max_iter: int = 20000,
                   check_every: int = 10, tol: float = 1e-9) -> SolveResult:
    """FISTA with adaptive restart for problem (80), prox (v - t*lam)_+.

    The same restart rule and the same gap test every ``check_every``
    iterations (against ``tol * 0.5||y||^2``) as ``fista_sgl``."""
    dtype, dev = X.dtype, X.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    lipschitz = torch.as_tensor(lipschitz, dtype=dtype, device=dev)
    beta0 = beta0.to(dtype)
    tol = SQUARED.effective_tol(tol, dtype)
    t_step = 1.0 / lipschitz
    t_lam = t_step * lam
    threshold = tol * SQUARED.gap_scale(y)

    beta, z = beta0, beta0
    tk = torch.ones((), dtype=dtype, device=dev)
    it = 0
    gap = torch.full((), float("inf"), dtype=dtype, device=dev)
    theta = None
    while it < max_iter and bool(gap > threshold):
        for _ in range(check_every):
            g = X.T @ (X @ z - y)
            beta_new = nn_lasso_prox(z - t_step * g, t_lam)
            restart = torch.dot(z - beta_new, beta_new - beta) > 0
            tk = torch.where(restart, 1.0, tk)
            tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
            z = beta_new + ((tk - 1.0) / tk1) * (beta_new - beta)
            beta, tk = beta_new, tk1
        pval, dval, theta = _nn_gap(X, y, lam, beta)
        it += check_every
        gap = (pval - dval).to(dtype)
    if theta is None:                   # max_iter <= 0: no check ran
        _, _, theta = _nn_gap(X, y, lam, beta)
    return SolveResult(beta, theta, gap, it)
