"""Model selection: fold-batched K-fold CV and stability selection (the
port of ``examples/cv_model_selection.py``).

The paper makes one lambda path cheap; this example shows the workload
those cheap paths unlock: picking lambda by cross-validation and scoring
features by stability selection, with all folds / subsamples screened in
one stacked GEMM per segment and solved in one fold-batched sweep
(``core/cv.py``).  Compares against solving each fold independently and
prints the engine counters that prove the batching (screens == segments,
not segments x folds).  The reference builds float64 data and runs it in
float32 (JAX's default); so does this port, by asking for float32.  On
the card it launches ``screen_norms_folds``, graphed ``sgl_prox`` blocks
and ``xtv``.

    PYTHONPATH=src python -m repro_torch.examples.cv_model_selection [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..api import SGLCV
from ..core import GroupSpec, sgl_cv, sgl_path, stability_selection
from ..core.groups import resolve_device
from .common import device_from_argv, timed


def data(N: int = 200, G: int = 100, n: int = 8, seed: int = 0):
    """The reference's problem: 10% of the groups carry signal, 3 features
    each, noise 0.5.  (X, y, beta_true, true_groups), float64 numpy."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta_true = np.zeros(p)
    true_groups = rng.choice(G, G // 10, replace=False)
    for g in true_groups:
        idx = g * n + rng.choice(n, 3, replace=False)
        beta_true[idx] = rng.standard_normal(3)
    y = X @ beta_true + 0.5 * rng.standard_normal(N)
    return X, y, beta_true, true_groups


def plan_kwargs(n_lambdas: int = 24) -> dict:
    return dict(n_lambdas=n_lambdas, min_ratio=0.03, tol=1e-7, safety=1e-8,
                max_iter=8000, check_every=50)


def run(N: int = 200, G: int = 100, n: int = 8, K: int = 5,
        n_lambdas: int = 24, n_subsamples: int = 20, stab_lambdas: int = 12,
        device=None, dtype=torch.float32) -> dict:
    """Fold-batched CV against K independent paths on its folds and grid,
    the ``SGLCV`` estimator, and stability selection (``device=None`` is
    the card).  Returns the results, the walls (s) and what the script
    prints."""
    dev = resolve_device(device)
    X, y, beta_true, true_groups = data(N, G, n)
    spec = GroupSpec.uniform_groups(G, n, device="cpu")
    kw = plan_kwargs(n_lambdas)
    on = dict(device=dev, dtype=dtype)

    # --- fold-batched CV vs K independent paths ---------------------------
    cv, t_batched = timed(dev, sgl_cv, X, y, spec, 1.0, n_folds=K, **kw,
                          **on)

    def sequential():
        paths = [sgl_path(X[train], y[train], spec, 1.0, lambdas=cv.lambdas,
                          engine="batched", **kw, **on)
                 for train, _ in cv.folds]
        return [p.betas for p in paths]

    seq_betas, t_seq = timed(dev, sequential)
    worst = max(float(np.max(np.abs(b - cv.fold_betas[k])))
                for k, b in enumerate(seq_betas))

    # --- the estimator facade ---------------------------------------------
    est, t_est = timed(dev, SGLCV(alpha=1.0, groups=[n] * G, n_folds=K,
                                  n_lambdas=n_lambdas, min_ratio=0.03,
                                  tol=1e-7, max_iter=8000, **on).fit, X, y)
    gids = spec.group_ids.cpu().numpy()
    sel_groups = np.unique(gids[np.abs(est.coef_) > 1e-6])
    hit = len(np.intersect1d(sel_groups, true_groups))

    # --- stability selection ----------------------------------------------
    stab, t_stab = timed(dev, stability_selection, X, y, spec, 1.0,
                         n_subsamples=n_subsamples, n_lambdas=stab_lambdas,
                         tol=1e-6, batch_size=10, seed=1, **on)
    true_feats = np.abs(beta_true) > 0
    stable = stab.max_probs >= 0.75
    return dict(
        cv=cv, seq_betas=seq_betas, est=est, stab=stab, K=K, worst=worst,
        r2=float(est.score(X, y)), sel_groups=sel_groups, hit=hit,
        true_groups=true_groups, true_feats=true_feats, stable=stable,
        walls=dict(cv=t_batched, sequential=t_seq, sglcv=t_est,
                   stability=t_stab))


def report(out: dict) -> None:
    """Print ``run``'s quantities in the reference's words and order."""
    cv, K, walls = out["cv"], out["K"], out["walls"]
    t_batched, t_seq = walls["cv"], walls["sequential"]
    print(f"lambda grid: {len(cv.lambdas)} points, "
          f"lambda_max = {cv.lam_max:.3f}")
    print(f"best lambda  = {cv.best_lambda:.4f} "
          f"(index {cv.best_index}, mean MSE "
          f"{cv.mean_mse[cv.best_index]:.4f})")
    print(f"1-SE lambda  = {cv.lambda_1se:.4f} (sparser model within one SE)")
    st = cv.stats
    print(f"\nfold-batched CV : {t_batched:5.2f}s (cold, incl. graph "
          f"capture)   stacked screens {st.n_screens} == segments "
          f"{st.n_segments} (NOT {st.n_segments} x {K} folds)")
    print(f"{K} sequential    : {t_seq:5.2f}s")
    print(f"ratio {t_seq / t_batched:4.1f}x")
    print(f"max |beta_batched - beta_independent| = {out['worst']:.2e}")
    print(f"\nSGLCV estimator: R^2 = {out['r2']:.4f}, "
          f"{out['hit']}/{len(out['true_groups'])} true groups recovered "
          f"({len(out['sel_groups'])} selected) in {walls['sglcv']:.2f}s")
    stab, true_feats, stable = out["stab"], out["true_feats"], out["stable"]
    print(f"\nstability selection over {stab.n_subsamples} half-subsamples "
          f"in {walls['stability']:.2f}s:")
    print(f"  mean max-prob on true features : "
          f"{stab.max_probs[true_feats].mean():.2f}")
    print(f"  mean max-prob on null features : "
          f"{stab.max_probs[~true_feats].mean():.2f}")
    tp = int((stable & true_feats).sum())
    print(f"  stable set (prob >= 0.75): {int(stable.sum())} features, "
          f"{tp} of {int(true_feats.sum())} true ones")


def main(argv=None) -> dict:
    out = run(device=device_from_argv(__doc__, argv))
    report(out)
    return out


if __name__ == "__main__":
    main()
