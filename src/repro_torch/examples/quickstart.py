"""Quickstart: Sparse-Group Lasso with TLFre two-layer screening (the port
of ``examples/quickstart.py``).

Solves a 40-point lambda path on a synthetic problem three ways: the
batched engine (grid screening, speculative sweeps, in-sweep
certification) through the Problem/Plan/Session API, the legacy
per-lambda driver, and the unscreened baseline.  Prints per-lambda
rejection, the speedups, and the engine's host-interaction counters.  On
the card at float32 the engine launches ``xtv``, ``screen_norms`` and
graphed ``sgl_prox`` blocks.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import GroupSpec, Plan, Problem, SGLSession, sgl_path
from ..core.groups import resolve_device
from .common import device_from_argv, timed

ALPHA = 1.0                                               # tan(45 deg)


def data(N: int = 250, G: int = 150, n: int = 10, seed: int = 0):
    """The reference's synthetic problem (paper Section 6.1.1 protocol):
    10% of the groups active, 10% of their features.  (X, y) float32."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    for g in rng.choice(G, G // 10, replace=False):
        idx = g * n + rng.choice(n, n // 10 + 1, replace=False)
        beta_true[idx] = rng.standard_normal(len(idx))
    y = (X @ beta_true + 0.01 * rng.standard_normal(N)).astype(np.float32)
    return X, y


def plan_kwargs(n_lambdas: int = 40) -> dict:
    return dict(n_lambdas=n_lambdas, tol=1e-6, safety=1e-6, max_iter=6000,
                check_every=50)


def run(N: int = 250, G: int = 150, n: int = 10, n_lambdas: int = 40,
        device=None, dtype=torch.float32) -> dict:
    """The batched engine, the legacy driver and the unscreened baseline
    on one problem (``device=None`` is the card).  Returns the three
    ``PathResult``s, their walls (s) and what the script prints."""
    dev = resolve_device(device)
    X, y = data(N, G, n)
    spec = GroupSpec.uniform_groups(G, n, device="cpu")
    kw = plan_kwargs(n_lambdas)
    session = SGLSession(Problem.sgl(X, y, spec, dtype=dtype, device=dev))
    res, t_engine = timed(dev, session.path, Plan(alpha=ALPHA, **kw))
    legacy, t_legacy = timed(dev, sgl_path, X, y, spec, ALPHA, device=dev,
                             dtype=dtype, **kw)
    base, t_base = timed(dev, sgl_path, X, y, spec, ALPHA, screen="none",
                         device=dev, dtype=dtype, **kw)
    st = res.stats
    return dict(
        res=res, legacy=legacy, base=base, p=G * n, G=G,
        agree=float(np.max(np.abs(res.betas - base.betas))),
        agree_legacy=float(np.max(np.abs(res.betas - legacy.betas))),
        round_trips=st.n_segments + st.n_screens,
        compilations=st.n_compilations,
        walls=dict(engine=t_engine, legacy=t_legacy, baseline=t_base),
        speedup=t_base / t_engine)


def report(out: dict) -> None:
    """Print ``run``'s quantities in the reference's words and order."""
    res, walls = out["res"], out["walls"]
    print(f"lambda_max = {res.lam_max:.3f}")
    print("lam/lam_max   kept features (of %d)   kept groups (of %d)"
          % (out["p"], out["G"]))
    for j in range(0, len(res.lambdas), 8):
        print(f"  {res.lambdas[j]/res.lam_max:8.3f}   "
              f"{res.kept_features[j]:8d}"
              f"              {res.kept_groups[j]:6d}")
    print(f"\nmax |beta_engine - beta_baseline| = {out['agree']:.2e}  "
          f"(safe: identical)")
    print(f"max |beta_engine - beta_legacy|   = {out['agree_legacy']:.2e}")
    print(f"engine host round-trips : {out['round_trips']} "
          f"(legacy makes {len(res.lambdas)}); "
          f"solver compilations: {out['compilations']}")
    print(f"batched engine: {walls['engine']:6.2f}s "
          f"(screening only {res.screen_time:4.2f}s)")
    print(f"legacy driver : {walls['legacy']:6.2f}s")
    print(f"baseline path : {walls['baseline']:6.2f}s")
    print(f"SPEEDUP vs baseline : {out['speedup']:5.1f}x")


def main(argv=None) -> dict:
    out = run(device=device_from_argv(__doc__, argv))
    report(out)
    return out


if __name__ == "__main__":
    main()
