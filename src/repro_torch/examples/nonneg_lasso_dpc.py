"""DPC screening for the nonnegative Lasso (paper Section 5 / Table 3; the
port of ``examples/nonneg_lasso_dpc.py``).

Nonnegative sparse coding of one 'image' against a dictionary of others,
with the DPC rule discarding provably-inactive atoms before each solve.
On the card at float32 the batched engine certifies each row with ``xtv``.

    PYTHONPATH=src python -m repro_torch.examples.nonneg_lasso_dpc [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import nn_lasso_path
from ..core.groups import resolve_device
from .common import device_from_argv, timed


def data(N: int = 400, p: int = 3000, n_hot: int = 40, seed: int = 0):
    """The reference's dictionary and signal: ``n_hot`` nonnegative atoms.
    (X, y) float32."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    hot = rng.choice(p, n_hot, replace=False)
    beta_true[hot] = np.abs(rng.standard_normal(n_hot))
    y = (X @ beta_true + 0.01 * rng.standard_normal(N)).astype(np.float32)
    return X, y


def run(N: int = 400, p: int = 3000, n_hot: int = 40, n_lambdas: int = 40,
        device=None, dtype=torch.float32) -> dict:
    """The DPC-screened batched path against the unscreened one
    (``device=None`` is the card).  Returns both ``PathResult``s, their
    walls (s) and what the script prints."""
    dev = resolve_device(device)
    X, y = data(N, p, n_hot)
    res, t_dpc = timed(dev, nn_lasso_path, X, y, n_lambdas=n_lambdas,
                       tol=1e-6, safety=1e-6, max_iter=6000, check_every=50,
                       engine="batched", device=dev, dtype=dtype)
    base, t_base = timed(dev, nn_lasso_path, X, y, n_lambdas=n_lambdas,
                         tol=1e-6, screen="none", max_iter=6000,
                         check_every=50, device=dev, dtype=dtype)
    return dict(res=res, base=base, p=p,
                agree=float(np.max(np.abs(res.betas - base.betas))),
                round_trips=res.stats.n_segments + res.stats.n_screens,
                walls=dict(dpc=t_dpc, baseline=t_base),
                speedup=t_base / t_dpc)


def report(out: dict) -> None:
    """Print ``run``'s quantities in the reference's words and order."""
    res, walls = out["res"], out["walls"]
    print(f"lambda_max = {res.lam_max:.3f}")
    print("lam/lam_max   atoms entering solver (of %d)" % out["p"])
    for j in range(0, len(res.lambdas), 8):
        print(f"  {res.lambdas[j]/res.lam_max:8.3f}   "
              f"{res.kept_features[j]:8d}")
    print(f"\nmax |beta_dpc - beta_baseline| = {out['agree']:.2e}")
    print(f"engine host round-trips: {out['round_trips']}"
          f" (legacy would make {len(res.lambdas)})")
    print(f"DPC path      : {walls['dpc']:6.2f}s")
    print(f"baseline path : {walls['baseline']:6.2f}s")
    print(f"SPEEDUP       : {out['speedup']:5.1f}x")


def main(argv=None) -> dict:
    out = run(device=device_from_argv(__doc__, argv))
    report(out)
    return out


if __name__ == "__main__":
    main()
