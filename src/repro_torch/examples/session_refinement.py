"""Two-stage model selection on a persistent SGLSession, plus the serving
front end (the port of ``examples/session_refinement.py``).

One declarative surface over path, CV, and serving:

  1. Build an immutable ``Problem`` and a declarative ``Plan``.
  2. ``session.cv(plan)``: fold-batched K-fold CV on a coarse grid.
  3. ``session.refine(factor=10)``: a finer grid around the selected
     lambda, seeded from the coarse run's certified per-fold duals and
     reusing the session's sweep buckets and graphs: the same answer as an
     exhaustive fine-grid CV, warm.
  4. ``SGLServer``: queue (X, y, groups) jobs; same-design jobs stack
     their CV folds into ONE fold-batched engine call, and every job
     shares the server's graph cache.

The reference builds float64 data and runs it in float32 (JAX's default);
so does this port, by asking for float32.  On the card it launches
``screen_norms_folds``, graphed ``sgl_prox`` blocks and ``xtv``.

    PYTHONPATH=src python -m repro_torch.examples.session_refinement [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import GroupSpec, Plan, Problem, SGLSession
from ..core.groups import resolve_device
from ..launch.sgl_serve import SGLServer
from .common import device_from_argv, timed


def data(N: int = 150, G: int = 60, n: int = 5, seed: int = 0):
    """The reference's problem with a real bias/variance tradeoff: 6 active
    groups of 2 features, noise 1.5.  (X, y, beta_true, rng), float64
    numpy; ``rng`` goes on to draw the serving jobs."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta_true = np.zeros(p)
    for g in rng.choice(G, 6, replace=False):
        beta_true[g * n + rng.choice(n, 2, replace=False)] = \
            rng.standard_normal(2)
    y = X @ beta_true + 1.5 * rng.standard_normal(N)
    return X, y, beta_true, rng


def run(N: int = 150, G: int = 60, n: int = 5, n_folds: int = 3,
        n_lambdas: int = 24, serve_lambdas: int = 16, device=None,
        dtype=torch.float32) -> dict:
    """Coarse CV, warm refinement, the cold fine CV it is held against, and
    three jobs through ``SGLServer`` (``device=None`` is the card).
    Returns the results, the walls (s) and what the script prints."""
    dev = resolve_device(device)
    X, y, beta_true, rng = data(N, G, n)
    p = G * n
    problem = Problem.sgl(X, y, groups=GroupSpec.uniform_groups(G, n, dev),
                          dtype=dtype, device=dev)
    plan = Plan(alpha=1.0, n_lambdas=n_lambdas, n_folds=n_folds, tol=3e-6,
                safety=1e-6, max_iter=8000, check_every=50)
    session = SGLSession(problem, plan)

    # --- stage 1: coarse CV; stage 2: warm refinement around it ------------
    coarse, t_coarse = timed(dev, session.cv)
    ref, t_ref = timed(dev, session.refine, factor=10.0)

    # cold comparison: the same fine grid on a fresh session
    cold, t_cold = timed(dev, SGLSession(problem).cv,
                         plan.with_(lambdas=ref.fine.lambdas))

    # --- model-selection-as-a-service -----------------------------------------
    server = SGLServer(Plan(n_folds=n_folds, n_lambdas=serve_lambdas,
                            tol=1e-6, safety=1e-6, max_iter=6000,
                            check_every=50), device=dev, dtype=dtype)
    # three responses, two over ONE shared design -> their folds run as one
    # fold-stacked engine call; a second design runs separately but shares
    # the graph cache
    for X_job in (X, X):
        yb = X_job @ beta_true + 0.5 * rng.standard_normal(N)
        server.submit(X_job, yb, groups=[n] * G)
    server.submit(rng.standard_normal((N, p)), y, groups=[n] * G)
    results, t_serve = timed(dev, server.drain)
    return dict(
        coarse=coarse, refined=ref, cold=cold, results=results,
        agree=float(np.max(np.abs(ref.fine.fold_betas - cold.fold_betas))),
        same_selection=ref.lambda_ == cold.best_lambda,
        walls=dict(coarse=t_coarse, refine=t_ref, cold=t_cold,
                   serve=t_serve))


def report(out: dict) -> None:
    """Print ``run``'s quantities in the reference's words and order."""
    coarse, ref, cold = out["coarse"], out["refined"], out["cold"]
    walls = out["walls"]
    print(f"coarse grid : {len(coarse.lambdas)} lambdas in "
          f"{walls['coarse']:.2f}s, best lambda/lam_max = "
          f"{coarse.best_lambda / coarse.lam_max:.4f}, "
          f"compilations = {coarse.stats.n_compilations}")
    print(f"refinement  : {len(ref.fine.lambdas)} lambdas spanning 10x "
          f"around {coarse.best_lambda:.4f} in {walls['refine']:.2f}s")
    print(f"  selected lambda       : {ref.lambda_:.4f} "
          f"(coarse pick was {coarse.best_lambda:.4f})")
    print(f"  warm-start reference  : {ref.warm_start_lambda:.4f} "
          f"(coarse certified duals)")
    print(f"  new sweep compilations: {ref.new_compilations} "
          f"(bucket shapes not already compiled by the coarse run)")
    print(f"  total FISTA iterations: {ref.total_iters}")
    print(f"cold fine CV: {walls['cold']:.2f}s, "
          f"{int(cold.fold_iters.sum())} FISTA iterations, "
          f"{cold.stats.n_compilations} compilations")
    print(f"  warm == cold to {out['agree']:.2e}; same selection: "
          f"{out['same_selection']}")
    results, t_serve = out["results"], walls["serve"]
    print(f"\nserve       : {len(results)} jobs in {t_serve:.2f}s "
          f"({t_serve / len(results) * 1e3:.0f}ms/job)")
    for jid, r in sorted(results.items()):
        print(f"  job {jid}: best_lambda={r.best_lambda:.4f} "
              f"nnz={int(np.sum(np.abs(r.coef) > 1e-8))} "
              f"batched_with={r.batched_with} "
              f"latency={r.latency * 1e3:.0f}ms")


def main(argv=None) -> dict:
    out = run(device=device_from_argv(__doc__, argv))
    report(out)
    return out


if __name__ == "__main__":
    main()
