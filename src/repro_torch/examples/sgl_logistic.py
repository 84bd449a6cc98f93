"""Sparse-group logistic regression through the loss-generic engine (the
port of ``examples/sgl_logistic.py``).

Solves a Gap-Safe-screened lambda path on a synthetic binary
classification problem (the engine's FISTA cores, duality gaps, and
screening all run from the logistic ``Loss`` object), compares it against
the unscreened path, adds adaptive per-group / per-feature penalty
weights, and finishes with the sklearn-style ``SGLClassifier`` facade:
single-lambda fit, probabilities, accuracy, and model selection over
``lam`` through ``get_params`` / ``set_params``.

The reference's last block hands ``SGLClassifier`` to sklearn's
``GridSearchCV``.  sklearn 1.9 refuses the estimators of both packages
there (they carry no ``__sklearn_tags__``), and the refusal is not the
``ImportError`` that the reference catches, so its script stops.  This
port runs the same two-point grid by hand: each candidate ``lam`` is
fitted on a ``sklearn.base.clone`` of the estimator on one half of the
rows and scored on the other, both ways, and the best mean accuracy wins.

The reference builds float64 data and runs it in float32 (JAX's default);
so does this port, by asking for float32.  On the card the screened path
launches graphed ``sgl_prox`` blocks, ``xtv`` and ``screen_norms``.

    PYTHONPATH=src python -m repro_torch.examples.sgl_logistic [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..api import SGLClassifier
from ..core import GroupSpec, Plan, Problem, SGLSession
from ..core.groups import resolve_device
from .common import device_from_argv, timed


def data(N: int = 200, G: int = 40, n: int = 5, seed: int = 0):
    """The reference's binary problem: 4 active groups, 3 features each,
    labels drawn from the logistic model.  (X, y, rng), float64 numpy;
    ``rng`` goes on to draw the adaptive weights."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta_true = np.zeros(p)
    for g in rng.choice(G, 4, replace=False):
        beta_true[g * n: g * n + 3] = rng.standard_normal(3)
    y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-X @ beta_true))
         ).astype(float)
    return X, y, rng


def plan_kwargs(n_lambdas: int = 20) -> dict:
    return dict(alpha=0.9, n_lambdas=n_lambdas, min_ratio=0.05, tol=1e-8,
                max_iter=20000)


def grid_by_hand(base, X, y, lams):
    """The two-fold grid over ``lam`` that ``GridSearchCV(cv=2)`` runs:
    ``clone(base)`` fitted on one half of the rows, scored on the other,
    mean over both halves.  (best lam, its mean accuracy, the means)."""
    from sklearn.base import clone
    halves = np.array_split(np.arange(len(y)), 2)
    scores = []
    for lam in lams:
        s = []
        for k in range(2):
            train, test = halves[1 - k], halves[k]
            est = clone(base).set_params(lam=lam).fit(X[train], y[train])
            s.append(est.score(X[test], y[test]))
        scores.append(float(np.mean(s)))
    best = int(np.argmax(scores))
    return lams[best], scores[best], scores


def run(N: int = 200, G: int = 40, n: int = 5, n_lambdas: int = 20,
        device=None, dtype=torch.float32) -> dict:
    """The screened and unscreened logistic paths, the weighted path, the
    classifier at 0.2 lambda_max and the grid (``device=None`` is the
    card).  Returns the results, the walls (s) and what the script
    prints; ``grid`` is None, and has no wall, without sklearn."""
    dev = resolve_device(device)
    X, y, rng = data(N, G, n)
    p = G * n
    spec = GroupSpec.uniform_groups(G, n, device="cpu")
    kw = plan_kwargs(n_lambdas)
    on = dict(device=dev, dtype=dtype)

    # --- Gap-Safe-screened logistic path vs unscreened --------------------
    session = SGLSession(Problem.sgl_logistic(X, y, spec, **on))
    res, t_res = timed(dev, session.path, Plan(screen="gapsafe", **kw))
    base, t_base = timed(dev, session.path, Plan(screen="none", **kw))

    # --- adaptive per-group / per-feature weights ride the same engine ----
    wspec = GroupSpec.from_sizes([n] * G, weights=rng.uniform(0.5, 2.0, G),
                                 feature_weights=rng.uniform(0.5, 2.0, p),
                                 device="cpu")
    wres, t_w = timed(dev, SGLSession(
        Problem.sgl_logistic(X, y, wspec, **on)).path,
        Plan(screen="gapsafe", **kw))

    # --- sklearn-style facade ---------------------------------------------
    lam = 0.2 * res.lam_max
    clf, t_clf = timed(dev, SGLClassifier(lam=lam, alpha=0.9,
                                          groups=[n] * G, **on).fit, X, y)
    lams = [0.5 * res.lam_max, 0.2 * res.lam_max]
    walls = dict(gapsafe=t_res, unscreened=t_base, weighted=t_w,
                 classifier=t_clf)
    try:
        grid, walls["grid"] = timed(
            dev, grid_by_hand, SGLClassifier(alpha=0.9, groups=[n] * G,
                                             **on), X, y, lams)
    except ImportError:
        grid = None
    return dict(
        res=res, base=base, wres=wres, clf=clf, lam=lam, p=p, G=G,
        agree=float(np.max(np.abs(np.asarray(res.betas)
                                  - np.asarray(base.betas)))),
        accuracy=float(clf.score(X, y)), proba=clf.predict_proba(X[:5]),
        nnz=int(np.count_nonzero(clf.coef_)), grid_lams=lams, grid=grid,
        walls=walls)


def report(out: dict) -> None:
    """Print ``run``'s quantities in the reference's words and order."""
    res, wres, clf, walls = out["res"], out["wres"], out["clf"], out["walls"]
    print(f"lambda_max = {res.lam_max:.4f}")
    print("lam/lam_max   kept features (of %d)   kept groups (of %d)"
          % (out["p"], out["G"]))
    for j in range(0, len(res.lambdas), 4):
        print(f"  {res.lambdas[j]/res.lam_max:8.3f}   "
              f"{res.kept_features[j]:8d}"
              f"              {res.kept_groups[j]:6d}")
    print(f"max |beta_screened - beta_unscreened| = {out['agree']:.2e}  "
          f"(safe rule)")
    print(f"Gap-Safe path {walls['gapsafe']:.2f}s, unscreened path "
          f"{walls['unscreened']:.2f}s")
    print(f"adaptive-weight path: kept {wres.kept_features[-1]} features at "
          f"lam/lam_max = {wres.lambdas[-1]/wres.lam_max:.3f} "
          f"({walls['weighted']:.2f}s)")
    print(f"SGLClassifier(lam={out['lam']:.3f}): accuracy "
          f"{out['accuracy']:.3f}, {out['nnz']} nonzero coefficients "
          f"({clf.kept_features_} survived the screen)")
    print("predict_proba [P(y=0), P(y=1)] head:",
          np.round(out["proba"], 3).tolist())
    if out["grid"] is None:
        print("sklearn not installed - skipping the grid over lam")
        return
    best, score, _ = out["grid"]
    print(f"two-fold grid by hand (GridSearchCV's cv=2) best lam = "
          f"{best:.3f} (accuracy {score:.3f}) in {walls['grid']:.2f}s")


def main(argv=None) -> dict:
    out = run(device=device_from_argv(__doc__, argv))
    report(out)
    return out


if __name__ == "__main__":
    main()
