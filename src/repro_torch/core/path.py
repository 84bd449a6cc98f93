"""Pathwise SGL / nonnegative-Lasso drivers with TLFre / DPC screening
(PyTorch port of ``repro.core.path``).

The paper's experimental protocol (Section 6): a geometric grid of 100
lambda values from lambda_max down to 0.01*lambda_max; at each lambda the
screening rule runs against the previous EXACT dual optimum, the
certified-zero columns are *physically removed*, the reduced problem is
solved (warm-started), and the exact dual is rebuilt from the full X.

``engine='legacy'`` is that per-lambda driver; ``engine='batched'`` is a
thin shim over ``SGLSession.path`` (``core.path_engine``).  The legacy
driver's screen modes are the reference's: ``screen='none'`` solves the
full problem at every lambda, and ANY other value runs TLFre (DPC for the
nonnegative Lasso), ``'gapsafe'`` included, as the reference's driver
does.  On float32 CUDA (``path_engine._kernels_active``) the driver runs
the ported kernels: the screen's GEMV and each row's certification GEMV
through ``xtv``, the Theorem-15 group statistics through ``screen_norms``
(no feature weights), and FISTA through graphed ``sgl_prox`` blocks (no
feature weights); float64 never runs a kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .dpc import (dpc_screen, dual_scaling_nn, lambda_max_nn,
                  normal_vector_nn)
from .estimation import estimate_dual_ball, normal_vector_sgl
from .groups import GroupSpec
from .lambda_max import dual_scaling_sgl, lambda_max_sgl
from .linalg import (column_norms, group_frobenius_norms,
                     group_spectral_norms, spectral_norm)
from .screening import _require_f32_for_pallas, _xtv, tlfre_screen
from .solver import solve_nn_lasso, solve_sgl


@dataclasses.dataclass
class PathResult:
    lambdas: np.ndarray                 # (J,)
    betas: np.ndarray                   # (J, p) float64, on the host
    lam_max: float
    screen_time: float                  # total screening seconds
    solve_time: float                   # total solver seconds
    setup_time: float                   # norms / lipschitz precompute
    iters: np.ndarray                   # (J,)
    kept_features: np.ndarray           # (J,) columns entering the solver
    kept_groups: Optional[np.ndarray] = None
    stats: Optional[object] = None      # EngineStats


def default_lambda_grid(lam_max: float, n: int = 100,
                        min_ratio: float = 0.01) -> np.ndarray:
    """n values equally spaced on log(lambda/lambda_max) from 1.0 down to
    min_ratio — INCLUDING the lam_max endpoint."""
    return lam_max * np.logspace(0.0, np.log10(min_ratio), n)


def _bucket(n: int, minimum: int = 64) -> int:
    """Next power-of-two bucket; keeps solver shapes to O(log p)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# SGL path
# ---------------------------------------------------------------------------

def sgl_path(X, y, spec, alpha, *, lambdas=None, n_lambdas=100,
             min_ratio=0.01, screen: str = "tlfre", tol=1e-9,
             max_iter: int = 20000, safety: float = 0.0,
             specnorm_method: str = "power", check_every: int = 10,
             engine: str = "legacy", device=None, dtype=None,
             **engine_kwargs) -> PathResult:
    """The SGL path over ``spec`` (a ``GroupSpec``, a list of group sizes
    or None).  ``engine='legacy'`` is the per-lambda driver;
    ``engine='batched'`` builds a one-shot ``Problem``/``Plan`` and runs
    ``SGLSession.path``, and alone accepts the ``Plan``'s engine knobs
    (``use_kernels``, ``min_bucket``, ``min_group_bucket``, ``margin``,
    ``chunk_init``).  ``device`` and ``dtype`` as in ``Problem.sgl``:
    ``device=None`` means the card."""
    from .problem import Problem
    if engine == "batched":
        from .problem import Plan, warn_legacy_entry_point
        from .session import SGLSession
        warn_legacy_entry_point("sgl_path(engine='batched')",
                                "SGLSession.path")
        plan = Plan(alpha=alpha, lambdas=lambdas, n_lambdas=n_lambdas,
                    min_ratio=min_ratio, screen=screen, tol=tol,
                    max_iter=max_iter, safety=safety,
                    specnorm_method=specnorm_method,
                    check_every=check_every, **engine_kwargs)
        return SGLSession(Problem.sgl(X, y, spec, dtype=dtype,
                                      device=device)).path(plan)
    if engine != "legacy":
        raise ValueError(f"unknown engine {engine!r}")
    if engine_kwargs:
        raise TypeError(f"engine='legacy' takes no extra kwargs, got "
                        f"{sorted(engine_kwargs)}")
    prob = Problem.sgl(X, y, spec, dtype=dtype, device=device)
    return _sgl_path_legacy(
        prob.X, prob.y, prob.spec, alpha, lambdas=lambdas,
        n_lambdas=n_lambdas, min_ratio=min_ratio, screen=screen, tol=tol,
        max_iter=max_iter, safety=safety, specnorm_method=specnorm_method,
        check_every=check_every, graphs={})


def _sgl_path_legacy(X, y, spec: GroupSpec, alpha, *, lambdas, n_lambdas,
                     min_ratio, screen, tol, max_iter, safety,
                     specnorm_method, check_every, use_kernels=None,
                     graphs=None) -> PathResult:
    """The per-lambda SGL driver on tensors of one device.  ``graphs``
    caches the captured FISTA blocks (``SGLSession`` passes its own);
    ``use_kernels`` as in ``sgl_path_batched`` (``None``: float32 on
    CUDA)."""
    from .path_engine import _kernels_active, _refuse_tf32, _sync
    if use_kernels:
        _require_f32_for_pallas(X.dtype)
    _refuse_tf32(X)
    dev, dtype = X.device, X.dtype
    N, p = X.shape
    G = spec.num_groups
    kernels = _kernels_active(use_kernels, dtype, dev)
    graphs = {} if graphs is None else graphs
    solve_kw = dict(max_iter=max_iter, tol=tol, check_every=check_every,
                    use_kernels=kernels, graphs=graphs)

    t0 = time.perf_counter()
    lam_max_t, g_star = lambda_max_sgl(spec, X.T @ y, alpha)
    lam_max = float(lam_max_t)
    col_n = column_norms(X)
    if specnorm_method == "power":
        gspec = group_spectral_norms(X, spec)
    else:
        gspec = group_frobenius_norms(X, spec)
    L = spectral_norm(X) ** 2
    _sync(dev)
    setup_time = time.perf_counter() - t0

    if lambdas is None:
        lambdas = default_lambda_grid(lam_max, n_lambdas, min_ratio)
    lambdas = np.asarray(lambdas, dtype=float)
    J = len(lambdas)

    rows = {}                           # j -> (p,) device row
    iters = np.zeros(J, dtype=np.int64)
    kept_feat = np.zeros(J, dtype=np.int64)
    kept_grp = np.zeros(J, dtype=np.int64)
    screen_time = 0.0
    solve_time = 0.0

    theta_bar = y / lam_max             # exact dual at lam_max (Thm 8)
    lam_bar = lam_max
    beta_prev = torch.zeros(p, dtype=dtype, device=dev)

    for j, lam in enumerate(lambdas):
        lam = float(lam)
        if lam >= lam_max * (1.0 - 1e-12):
            continue                    # beta* = 0 at/above lam_max

        if screen == "none":
            ts = time.perf_counter()
            res = solve_sgl(X, y, spec, lam, alpha, L, beta0=beta_prev,
                            **solve_kw)
            _sync(dev)
            solve_time += time.perf_counter() - ts
            beta_prev = rows[j] = res.beta
            iters[j] = res.iters
            kept_feat[j] = p
            kept_grp[j] = G
            theta_bar = res.theta
            lam_bar = lam
            continue

        # ---- screening against the previous exact dual optimum ----------
        ts = time.perf_counter()
        n_vec = normal_vector_sgl(X, y, spec, lam_bar, lam_max, theta_bar,
                                  g_star)
        ball = estimate_dual_ball(y, lam, lam_bar, theta_bar, n_vec)
        sres = tlfre_screen(X, spec, alpha, ball, col_n, gspec,
                            safety=safety, use_kernels=kernels)
        feat_keep = sres.feat_keep.cpu().numpy()
        kept_feat[j] = int(feat_keep.sum())
        kept_grp[j] = int(sres.group_keep.sum())
        screen_time += time.perf_counter() - ts

        ts = time.perf_counter()
        beta_full = torch.zeros(p, dtype=dtype, device=dev)
        if kept_feat[j] == 0:
            theta_bar = y / lam
            iters[j] = 0
        else:
            p_b = min(_bucket(kept_feat[j]), p)
            g_b = min(_bucket(kept_grp[j] + 1, minimum=16), G + 1)
            sub_spec, col_idx = spec.bucketed_subset(feat_keep, p_b, g_b)
            col_dev = torch.as_tensor(col_idx, device=dev)
            X_sub = torch.zeros((N, p_b), dtype=dtype, device=dev)
            X_sub[:, :len(col_idx)] = X.index_select(1, col_dev)
            L_sub = spectral_norm(X_sub, iters=25) ** 2
            beta0 = torch.zeros(p_b, dtype=dtype, device=dev)
            beta0[:len(col_idx)] = beta_prev[col_dev]
            res = solve_sgl(X_sub, y, sub_spec, lam, alpha, L_sub,
                            beta0=beta0, **solve_kw)
            beta_full[col_dev] = res.beta[:len(col_idx)]
            iters[j] = res.iters
            # exact dual: the residual of the REDUCED matrix (screened
            # coefficients are provably zero), scaled over the full X
            rho = (y - X_sub @ res.beta) / lam
            s = dual_scaling_sgl(spec, _xtv(X, rho, kernels).to(dtype),
                                 alpha)
            theta_bar = (s * rho).to(dtype)
            _sync(dev)
        solve_time += time.perf_counter() - ts
        beta_prev = rows[j] = beta_full
        lam_bar = lam

    return PathResult(lambdas=lambdas, betas=_host_rows(rows, J, p),
                      lam_max=lam_max, screen_time=screen_time,
                      solve_time=solve_time, setup_time=setup_time,
                      iters=iters, kept_features=kept_feat,
                      kept_groups=kept_grp)


def _host_rows(rows: dict, J: int, p: int) -> np.ndarray:
    """(J, p) float64 on the host; rows not in ``rows`` are zero."""
    betas = np.zeros((J, p))
    if rows:
        idx = sorted(rows)
        betas[idx] = torch.stack([rows[j] for j in idx]).cpu().numpy()
    return betas


# ---------------------------------------------------------------------------
# Nonnegative-Lasso path with DPC
# ---------------------------------------------------------------------------

def nn_lasso_path(X, y, *, lambdas=None, n_lambdas=100, min_ratio=0.01,
                  screen: str = "dpc", tol=1e-9, max_iter: int = 20000,
                  safety: float = 0.0, check_every: int = 10,
                  engine: str = "legacy", device=None, dtype=None,
                  **engine_kwargs) -> PathResult:
    """The nonnegative-Lasso path; engines, ``device`` and ``dtype`` as in
    ``sgl_path``."""
    from .problem import Problem
    if engine == "batched":
        from .problem import Plan, warn_legacy_entry_point
        from .session import SGLSession
        warn_legacy_entry_point("nn_lasso_path(engine='batched')",
                                "SGLSession.path")
        plan = Plan(lambdas=lambdas, n_lambdas=n_lambdas,
                    min_ratio=min_ratio, screen=screen, tol=tol,
                    max_iter=max_iter, safety=safety,
                    check_every=check_every, **engine_kwargs)
        return SGLSession(Problem.nn_lasso(X, y, dtype=dtype,
                                           device=device)).path(plan)
    if engine != "legacy":
        raise ValueError(f"unknown engine {engine!r}")
    if engine_kwargs:
        raise TypeError(f"engine='legacy' takes no extra kwargs, got "
                        f"{sorted(engine_kwargs)}")
    prob = Problem.nn_lasso(X, y, dtype=dtype, device=device)
    return _nn_lasso_path_legacy(
        prob.X, prob.y, lambdas=lambdas, n_lambdas=n_lambdas,
        min_ratio=min_ratio, screen=screen, tol=tol, max_iter=max_iter,
        safety=safety, check_every=check_every)


def _nn_lasso_path_legacy(X, y, *, lambdas, n_lambdas, min_ratio, screen,
                          tol, max_iter, safety, check_every,
                          use_kernels=None) -> PathResult:
    """The per-lambda nonnegative-Lasso driver; its only kernel is ``xtv``
    (the DPC screen's GEMV and each row's certification)."""
    from .path_engine import _kernels_active, _refuse_tf32, _sync
    if use_kernels:
        _require_f32_for_pallas(X.dtype)
    _refuse_tf32(X)
    dev, dtype = X.device, X.dtype
    N, p = X.shape
    kernels = _kernels_active(use_kernels, dtype, dev)
    solve_kw = dict(max_iter=max_iter, tol=tol, check_every=check_every)

    t0 = time.perf_counter()
    lam_max_t, i_star = lambda_max_nn(X.T @ y)
    lam_max = float(lam_max_t)
    if lam_max <= 0:
        raise ValueError("max_i <x_i, y> <= 0: nonnegative Lasso solution is "
                         "identically zero for every lambda > 0")
    col_n = column_norms(X)
    L = spectral_norm(X) ** 2
    _sync(dev)
    setup_time = time.perf_counter() - t0

    if lambdas is None:
        lambdas = default_lambda_grid(lam_max, n_lambdas, min_ratio)
    lambdas = np.asarray(lambdas, dtype=float)
    J = len(lambdas)

    rows = {}
    iters = np.zeros(J, dtype=np.int64)
    kept_feat = np.zeros(J, dtype=np.int64)
    screen_time = 0.0
    solve_time = 0.0

    theta_bar = y / lam_max
    lam_bar = lam_max
    beta_prev = torch.zeros(p, dtype=dtype, device=dev)

    for j, lam in enumerate(lambdas):
        lam = float(lam)
        if lam >= lam_max * (1.0 - 1e-12):
            continue

        if screen == "none":
            ts = time.perf_counter()
            res = solve_nn_lasso(X, y, lam, L, beta0=beta_prev, **solve_kw)
            _sync(dev)
            solve_time += time.perf_counter() - ts
            beta_prev = rows[j] = res.beta
            iters[j] = res.iters
            kept_feat[j] = p
            theta_bar = res.theta
            lam_bar = lam
            continue

        ts = time.perf_counter()
        n_vec = normal_vector_nn(X, y, lam_bar, lam_max, theta_bar, i_star)
        ball = estimate_dual_ball(y, lam, lam_bar, theta_bar, n_vec)
        feat_keep = dpc_screen(X, ball, col_n, safety=safety,
                               use_kernels=kernels).cpu().numpy()
        kept_feat[j] = int(feat_keep.sum())
        screen_time += time.perf_counter() - ts

        ts = time.perf_counter()
        beta_full = torch.zeros(p, dtype=dtype, device=dev)
        if kept_feat[j] == 0:
            theta_bar = y / lam
            iters[j] = 0
        else:
            col_idx = np.nonzero(feat_keep)[0]
            p_b = min(_bucket(len(col_idx)), p)
            col_dev = torch.as_tensor(col_idx, device=dev)
            X_sub = torch.zeros((N, p_b), dtype=dtype, device=dev)
            X_sub[:, :len(col_idx)] = X.index_select(1, col_dev)
            L_sub = spectral_norm(X_sub, iters=25) ** 2
            beta0 = torch.zeros(p_b, dtype=dtype, device=dev)
            beta0[:len(col_idx)] = beta_prev[col_dev]
            res = solve_nn_lasso(X_sub, y, lam, L_sub, beta0=beta0,
                                 **solve_kw)
            beta_full[col_dev] = res.beta[:len(col_idx)]
            iters[j] = res.iters
            rho = (y - X_sub @ res.beta) / lam
            s = dual_scaling_nn(_xtv(X, rho, kernels).to(dtype))
            theta_bar = (s * rho).to(dtype)
            _sync(dev)
        solve_time += time.perf_counter() - ts
        beta_prev = rows[j] = beta_full
        lam_bar = lam

    return PathResult(lambdas=lambdas, betas=_host_rows(rows, J, p),
                      lam_max=lam_max, screen_time=screen_time,
                      solve_time=solve_time, setup_time=setup_time,
                      iters=iters, kept_features=kept_feat)


# ---------------------------------------------------------------------------
# Rejection-ratio bookkeeping (paper Section 6 metrics)
# ---------------------------------------------------------------------------

def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def rejection_ratios_sgl(spec: GroupSpec, beta_exact, group_keep, feat_keep,
                         zero_tol: float = 1e-10):
    """r1, r2 of Section 6.1: the fractions of the m inactive features
    removed by layer 1 (whole groups) and by layer 2 (extra features).
    The masks and ``beta_exact`` may be numpy arrays or tensors."""
    gid = spec.group_ids.cpu().numpy()
    inactive = np.abs(_host_array(beta_exact)) <= zero_tol
    m = max(int(inactive.sum()), 1)
    dropped_by_l1 = ~_host_array(group_keep).astype(bool)[gid]
    r1 = float((dropped_by_l1 & inactive).sum()) / m
    dropped_by_l2 = ~_host_array(feat_keep).astype(bool) & ~dropped_by_l1
    r2 = float((dropped_by_l2 & inactive).sum()) / m
    return r1, r2
