"""Spectral-norm utilities (power method, per paper Section 6.1.1), PyTorch
port.  ``||X_g||_2`` per group and ``||X||_2`` for the FISTA step size.

The reference seeds ``spectral_norm`` with ``jax.random.normal``; those bits
cannot be reproduced here, so the start vector comes from numpy's generator
with the same seed.  The iteration counts are the reference's, so where
50 power steps converge the estimate differs from the reference's in its
last digits; where the two top singular values are close they may not, and
the two estimates can differ by several percent (one 60 x 40 Gaussian
design: 9.2%).
"""
from __future__ import annotations

import numpy as np
import torch

from .groups import GroupSpec, group_sum


def spectral_norm(X: torch.Tensor, iters: int = 50,
                  seed: int = 0) -> torch.Tensor:
    """||X||_2 via power iteration on X^T X (a 0-d tensor of X's dtype)."""
    p = X.shape[1]
    v0 = np.random.default_rng(seed).standard_normal(p)
    v = torch.as_tensor(v0, dtype=X.dtype, device=X.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = X.T @ (X @ v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return torch.linalg.vector_norm(X @ v)


def _masked_power(Xg: torch.Tensor, mask: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """Batched ||Xg * mask||_2: Xg (B, N, n), mask (B, n) -> (B,)."""
    m = mask.to(Xg.dtype)
    v = m / torch.sqrt(torch.clamp(m.sum(dim=1, keepdim=True), min=1.0))
    Xm = Xg * m[:, None, :]
    for _ in range(iters):
        w = torch.bmm(Xm.transpose(1, 2), torch.bmm(Xm, v[:, :, None]))[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=1, keepdim=True),
                            min=1e-30)
    return torch.linalg.vector_norm(torch.bmm(Xm, v[:, :, None])[..., 0],
                                    dim=1)


def group_spectral_norms(X: torch.Tensor, spec: GroupSpec,
                         iters: int = 30) -> torch.Tensor:
    """(G,) spectral norms ||X_g||_2.  Groups are gathered into the padded
    (G, N, n_max) layout and iterated together; padded slots are masked, so
    each group's iteration is the reference's."""
    N = X.shape[0]
    if spec.uniform:
        n = spec.max_size
        Xg = X.reshape(N, spec.num_groups, n).permute(1, 0, 2)
        mask = torch.ones((spec.num_groups, n), dtype=torch.bool,
                          device=X.device)
        return _masked_power(Xg, mask, iters)
    Xg = X[:, spec.pad_index].permute(1, 0, 2)        # (G, N, n_max)
    Xg = torch.where(spec.pad_mask[:, None, :], Xg, 0.0)
    return _masked_power(Xg, spec.pad_mask, iters)


def column_norms(X: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(X * X, dim=0))


def group_frobenius_norms(X: torch.Tensor, spec: GroupSpec) -> torch.Tensor:
    """Cheap safe upper bound ||X_g||_2 <= ||X_g||_F."""
    return torch.sqrt(group_sum(spec, torch.sum(X * X, dim=0)))
