"""Synthetic data following the paper's protocol (Section 6) — the port's
own copy of the generators in ``benchmarks/data_synth.py``, drawing the same
numbers from the same numpy seed.

Synthetic 1: X ~ iid N(0,1).  Synthetic 2: rows ~ N(0, Sigma),
Sigma_ij = 0.5^|i-j| (AR(1) recursion).  SGL beta*: gamma1 of the groups,
then gamma2 of the features inside each selected group, drawn from N(0,1);
nonnegative-Lasso beta*: |N(0,1)| on a fraction of the features;
y = X beta* + 0.01 eps.  The sparse-group logistic data copy the generator
of ``benchmarks/paper_tables.py:loss_logistic_bench``.
"""
from __future__ import annotations

import numpy as np


def synthetic_sgl(kind: int, N: int, G: int, n: int, gamma1: float,
                  gamma2: float, seed: int = 0):
    """(X float32 (N, G*n), y float32 (N,), beta* float64) as numpy."""
    rng = np.random.default_rng(seed)
    p = G * n
    if kind == 1:
        X = rng.standard_normal((N, p))
    else:
        rho = 0.5
        eps = rng.standard_normal((N, p))
        X = np.empty((N, p))
        X[:, 0] = eps[:, 0]
        c = np.sqrt(1 - rho * rho)
        for j in range(1, p):
            X[:, j] = rho * X[:, j - 1] + c * eps[:, j]
    beta = np.zeros(p)
    sel_g = rng.choice(G, max(1, int(G * gamma1)), replace=False)
    for g in sel_g:
        k = max(1, int(n * gamma2))
        idx = g * n + rng.choice(n, k, replace=False)
        beta[idx] = rng.standard_normal(k)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X.astype(np.float32), y.astype(np.float32), beta


def synthetic_nn(kind: int, N: int, p: int, frac: float = 0.1,
                 seed: int = 0):
    """Nonnegative-Lasso data (paper Table 3): X as in ``synthetic_sgl``,
    beta* nonnegative on ``frac`` of the features.  (X float32 (N, p),
    y float32 (N,), beta* float64) as numpy."""
    rng = np.random.default_rng(seed)
    if kind == 1:
        X = rng.standard_normal((N, p))
    else:
        rho = 0.5
        eps = rng.standard_normal((N, p))
        X = np.empty((N, p))
        X[:, 0] = eps[:, 0]
        c = np.sqrt(1 - rho * rho)
        for j in range(1, p):
            X[:, j] = rho * X[:, j - 1] + c * eps[:, j]
    beta = np.zeros(p)
    idx = rng.choice(p, max(1, int(p * frac)), replace=False)
    beta[idx] = np.abs(rng.standard_normal(len(idx)))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X.astype(np.float32), y.astype(np.float32), beta


def ragged_sizes(p: int, avg: float, seed: int = 0):
    """ADNI-like ragged group sizes (mean ~ p/G ~ 4.5 SNPs per gene)."""
    rng = np.random.default_rng(seed)
    sizes = []
    left = p
    while left > 0:
        s = min(int(rng.integers(1, int(2 * avg))) + 1, left)
        sizes.append(s)
        left -= s
    return sizes


def synthetic_logistic(N: int, G: int, n: int, seed: int = 7):
    """Sparse-group logistic data: X ~ iid N(0,1), all features of a
    twentieth of the groups (at least 2) drawn from N(0,1), labels
    ``1[X beta / sqrt(n * hot) + 0.5 eps > 0]``.  (X float64 (N, G*n),
    y float64 in {0, 1} (N,), beta* float64) as numpy."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    hot = rng.choice(G, max(G // 20, 2), replace=False)
    for g in hot:
        beta[g * n:(g + 1) * n] = rng.standard_normal(n)
    logits = X @ beta / np.sqrt(n * len(hot))
    y = (logits + 0.5 * rng.standard_normal(N) > 0).astype(float)
    return X, y, beta
