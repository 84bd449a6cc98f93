"""Model selection as a service on the Problem/Plan/Session engine
(PyTorch port).

A job queue that accepts ``(X, y, groups)`` fit requests and returns fitted
coefficients and CV curves, batching the work through persistent server
state at two levels:

  * **Fold stacking (same design).**  Jobs that share one design matrix
    (fingerprinted by content) and group spec differ only in their
    response, and the fold engine already solves K masked row subsets of
    ONE shared X together, so the server concatenates the jobs' CV folds
    (each with its own response row) into a single ``sgl_fold_paths`` call:
    one stacked ``(jobs*K*L, N) x (N, p)`` screening GEMM per step for the
    whole batch.

  * **Cache sharing (same bucket).**  Every engine call threads the
    server's one persistent compile-key set and its one cache of captured
    FISTA graphs, so jobs whose problems land in the same power-of-two
    buckets (same shapes, other data) run warm: the first job of a bucket
    pays the compilations and captures, every later job none.

Each job's refit at its selected lambda is a solo ``solve_sgl`` /
``solve_nn_lasso`` with ``check_every=10`` (at float32 through the kernel
route, graphed on the card, from the server's graph cache), so its
iterates and iteration count are those of a solo call.

``--smoke`` round-trips a synthetic batch twice (cold, then warm) and
reports the latency per job and the compilations, in float32::

    PYTHONPATH=src python -m repro_torch.launch.sgl_serve --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from ..core import (EngineStats, Plan, as_group_spec, kfold_indices,
                    lambda_max_nn, lambda_max_sgl, nn_fold_paths,
                    resolve_device, sgl_fold_paths, solve_nn_lasso,
                    solve_sgl, spectral_norm)
from ..core.cv import (_cv_statistics, _host, _masks_from_folds,
                      per_fold_centering)
from ..core.path import default_lambda_grid
from ..core.path_engine import _kernels_active
from ..core.problem import input_dtype


def _batch_lambda_max(X, ys, spec, alpha, *, penalty: str) -> torch.Tensor:
    """Every job's lambda_max: one (jobs, N) x (N, p) GEMM, then the
    Theorem-8 (sgl) / Theorem-20(iv) (nn_lasso) anchor of each row.
    ``spec`` is unused (None) for nn_lasso."""
    xty = ys @ X
    if penalty == "sgl":
        return torch.stack([lambda_max_sgl(spec, c, alpha)[0] for c in xty])
    return torch.stack([lambda_max_nn(c)[0] for c in xty])


def _batch_refit(X, ys, lams, spec, alpha, lipschitz, tol, *, penalty: str,
                 max_iter: int, check_every: int, use_kernels: bool,
                 graphs: dict):
    """Full-data refits at each job's selected lambda, one solo solve per
    job, so every job's iterates and iteration count are those of a solo
    ``solve_sgl`` / ``solve_nn_lasso`` call.  Returns (betas, iters)."""
    betas, iters = [], []
    for y, lam in zip(ys, lams):
        if penalty == "sgl":
            fit = solve_sgl(X, y, spec, lam, alpha, lipschitz,
                            max_iter=max_iter, check_every=check_every,
                            tol=tol, use_kernels=use_kernels, graphs=graphs)
        else:
            fit = solve_nn_lasso(X, y, lam, lipschitz, max_iter=max_iter,
                                 check_every=check_every, tol=tol)
        betas.append(fit.beta)
        iters.append(fit.iters)
    return torch.stack(betas), iters


@dataclasses.dataclass
class FitJob:
    """One queued model-selection request."""
    job_id: int
    X: np.ndarray                # (N, p) float64 on the host
    y: np.ndarray                # (N,) float64 on the host
    spec: object                 # GroupSpec (None for nn_lasso)
    penalty: str                 # "sgl" | "nn_lasso"
    alpha: float
    fingerprint: str             # content hash of X (fold-stacking key)
    dtype: torch.dtype           # compute dtype on the device


@dataclasses.dataclass
class JobResult:
    """Fitted coefficients and CV curves for one job.

    A failed batch yields results with ``error`` set and every other field
    at its placeholder default: one bad job must not lose the rest of the
    queue's work."""
    job_id: int
    lambdas: np.ndarray = None   # (J,) grid the CV curves live on
    mean_mse: np.ndarray = None  # (J,)
    se_mse: np.ndarray = None    # (J,)
    best_lambda: float = float("nan")
    lambda_1se: float = float("nan")
    coef: np.ndarray = None      # (p,) full-data refit at best_lambda
    n_iter: int = 0              # refit FISTA iterations
    latency: float = 0.0         # batch wall-clock / jobs in the batch
    batched_with: list = dataclasses.field(default_factory=list)
    new_compilations: int = 0    # sweep shapes this batch added server-wide
    error: str = None            # failure message (None => success)


def _fingerprint(X: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(X).tobytes()).hexdigest()[:16]


def _spec_key(spec) -> tuple:
    if spec is None:
        return ("nn",)
    # content hash of the FULL group structure: truncating it would merge
    # jobs whose specs differ only in the tail and solve one with the
    # other's groups
    digest = hashlib.sha1(
        spec.sizes.cpu().numpy().tobytes()
        + spec.weights.cpu().numpy().tobytes()).hexdigest()[:16]
    return (spec.num_features, spec.num_groups, digest)


class SGLServer:
    """Job-queue front end over the fold engine.

    ``submit`` enqueues; ``drain`` groups the queue into batches (jobs of
    the same X fingerprint, spec, alpha, penalty and dtype stack their
    folds into one engine call; all share the server's compile keys and
    graph cache) and returns ``{job_id: JobResult}``.  ``device=None``
    means the CUDA card (and raises without one); ``dtype=None`` keeps
    each job's input dtype.
    """

    def __init__(self, plan: Optional[Plan] = None, device=None,
                 dtype=None):
        self.plan = plan if plan is not None else Plan()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.compile_keys: set = set()   # shared across ALL jobs/buckets
        self.fista_graphs: dict = {}     # captured FISTA blocks (card)
        self.stats = EngineStats()
        self._queue: list = []
        self._next_id = 0

    # ---- queue ------------------------------------------------------------

    def submit(self, X, y, groups=None, *, alpha: float = 1.0,
               penalty: str = "sgl") -> int:
        """Enqueue a fit request; returns its job id."""
        if penalty not in ("sgl", "nn_lasso"):
            raise ValueError(f"unknown penalty {penalty!r}")
        self.plan.validate_for_penalty(penalty)
        dtype = input_dtype(X, self.dtype)
        X = _host(X)
        y = _host(y)
        spec = (as_group_spec(groups, X.shape[1], self.device)
                if penalty == "sgl" else None)
        job = FitJob(job_id=self._next_id, X=X, y=y, spec=spec,
                     penalty=penalty, alpha=float(alpha),
                     fingerprint=_fingerprint(X), dtype=dtype)
        self._next_id += 1
        self._queue.append(job)
        return job.job_id

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ---- batching ---------------------------------------------------------

    def _batches(self):
        """Group the queue by (design fingerprint, spec, alpha, penalty,
        dtype): the jobs of one batch share a design and stack their folds
        into a single engine call."""
        buckets: dict = {}
        for job in self._queue:
            key = (job.fingerprint, _spec_key(job.spec), job.alpha,
                   job.penalty, job.dtype)
            buckets.setdefault(key, []).append(job)
        return list(buckets.values())

    def _run_batch(self, jobs: list) -> dict:
        """One fold-stacked engine call for all jobs sharing a design.

        The grid is anchored at the batch's largest per-job lambda_max
        (grid points above a job's own lambda_max certify to exact zeros
        inside the engine, so every job's CV curve is still exact on the
        shared grid)."""
        plan = self.plan
        t0 = time.perf_counter()
        X = jobs[0].X
        N = X.shape[0]
        penalty = jobs[0].penalty
        spec = jobs[0].spec
        alpha = jobs[0].alpha
        X_d = torch.as_tensor(X, dtype=jobs[0].dtype, device=self.device)
        ys_d = torch.as_tensor(np.stack([job.y for job in jobs]),
                               dtype=X_d.dtype, device=self.device)

        # one batched GEMM and ONE host read for every job's anchor
        lam_maxes = [float(v) for v in _batch_lambda_max(
            X_d, ys_d, spec, alpha, penalty=penalty).cpu().numpy()]
        lam_anchor = max(lam_maxes)
        if lam_anchor <= 0:
            # every job of the batch is degenerate (e.g. nn_lasso with
            # max_i <x_i, y> <= 0): the exact solution is zero at EVERY
            # lambda > 0, so any grid carries the valid answer; anchor a
            # nominal one.  A batch with one non-degenerate job never lands
            # here: its degenerate members ride along as all-zero fold
            # paths inside the engine.
            lam_anchor = 1.0
        lambdas = (np.asarray(plan.lambdas, dtype=float)
                   if plan.lambdas is not None
                   else default_lambda_grid(lam_anchor, plan.n_lambdas,
                                            plan.min_ratio))

        # stack every job's K folds: per-fold masks, per-fold response rows
        folds = (plan.folds if plan.folds is not None
                 else kfold_indices(N, plan.n_folds, plan.seed))
        K = len(folds)
        masks1 = _masks_from_folds(folds, N)           # (K, N), shared split
        masks = np.tile(masks1, (len(jobs), 1))        # (jobs*K, N)
        y_rows = np.repeat(np.stack([job.y for job in jobs]), K, axis=0)
        mus = y_means = None
        if penalty == "sgl" and plan.center == "per-fold":
            per_job = [per_fold_centering(X, job.y, masks1) for job in jobs]
            mus = np.concatenate([m for m, _, _ in per_job])
            y_means = np.concatenate([ym for _, ym, _ in per_job])
            y_rows = np.concatenate([yr for _, _, yr in per_job])

        common = dict(tol=plan.tol, max_iter=plan.max_iter,
                      safety=plan.safety, check_every=plan.check_every,
                      min_bucket=plan.min_bucket, margin=plan.margin,
                      chunk_init=plan.chunk_init, chunk_cap=plan.chunk_cap,
                      schedule=plan.schedule, use_kernels=plan.use_kernels,
                      mesh=plan.mesh, compile_keys=self.compile_keys)
        n_comp0 = len(self.compile_keys)
        if penalty == "sgl":
            betas, kept, iters, stats, times = sgl_fold_paths(
                X_d, y_rows, spec, alpha, masks, lambdas,
                screen=plan.resolved_screen("sgl"),
                specnorm_method=plan.specnorm_method,
                min_group_bucket=plan.min_group_bucket, mus=mus,
                fista_graphs=self.fista_graphs, **common)
        else:
            betas, kept, iters, stats, times = nn_fold_paths(
                X_d, y_rows, masks, lambdas,
                screen=plan.resolved_screen("nn_lasso"), **common)
        new_comp = len(self.compile_keys) - n_comp0
        # buckets=False: the server's aggregate lives as long as the server
        self.stats.merge(stats, buckets=False)

        # per-job CV statistics on the host, then the refits
        L_full = spectral_norm(X_d) ** 2
        ids = [job.job_id for job in jobs]
        cvs, sel_lams = [], []
        for t, job in enumerate(jobs):
            sl = slice(t * K, (t + 1) * K)
            cv = _cv_statistics(
                X, job.y, folds, lambdas, betas[sl], lam_maxes[t], kept[sl],
                stats, times, iters=iters[sl],
                mus=None if mus is None else mus[sl],
                y_means=None if y_means is None else y_means[sl])
            cvs.append(cv)
            idx = (cv.best_index if plan.selection == "min"
                   else cv.index_1se)
            sel_lams.append(float(lambdas[idx]))
        # check_every=10, the solo solve_sgl / solve_nn_lasso default
        betas_fit, iters_fit = _batch_refit(
            X_d, ys_d, sel_lams, spec, alpha, L_full, plan.tol,
            penalty=penalty, max_iter=plan.max_iter, check_every=10,
            use_kernels=_kernels_active(plan.use_kernels, X_d.dtype,
                                        X_d.device),
            graphs=self.fista_graphs)
        betas_np = betas_fit.cpu().numpy()
        results = {}
        for t, job in enumerate(jobs):
            cv = cvs[t]
            results[job.job_id] = JobResult(
                job_id=job.job_id, lambdas=lambdas, mean_mse=cv.mean_mse,
                se_mse=cv.se_mse, best_lambda=cv.best_lambda,
                lambda_1se=cv.lambda_1se, coef=betas_np[t],
                n_iter=int(iters_fit[t]), latency=0.0, batched_with=ids,
                new_compilations=new_comp)
        wall = time.perf_counter() - t0
        for res in results.values():
            res.latency = wall / len(jobs)
        return results

    def drain(self) -> dict:
        """Process the whole queue; returns ``{job_id: JobResult}``.

        Batches are isolated: a batch that raises (bad input, such as an
        nn_lasso job on a design the engine refuses) yields error results
        for ITS jobs only; every other batch still runs and returns."""
        results: dict = {}
        batches = self._batches()
        self._queue = []
        for jobs in batches:
            try:
                results.update(self._run_batch(jobs))
            except Exception as exc:           # noqa: BLE001 — isolate batches
                ids = [job.job_id for job in jobs]
                for jid in ids:
                    results[jid] = JobResult(job_id=jid, batched_with=ids,
                                             error=str(exc))
        return results


# ---------------------------------------------------------------------------
# Smoke CLI
# ---------------------------------------------------------------------------

def _synthetic_jobs(rng, n_designs, jobs_per_design, N, G, n):
    p = G * n
    designs = [rng.standard_normal((N, p)) for _ in range(n_designs)]
    jobs = []
    for X in designs:
        for _ in range(jobs_per_design):
            beta = np.zeros(p)
            for g in rng.choice(G, max(G // 10, 1), replace=False):
                beta[g * n + rng.choice(n, 2, replace=False)] = \
                    rng.standard_normal(2)
            y = X @ beta + 0.01 * rng.standard_normal(N)
            jobs.append((X, y))
    return jobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="round-trip a synthetic batch and report latency")
    ap.add_argument("--designs", type=int, default=2)
    ap.add_argument("--jobs-per-design", type=int, default=3)
    ap.add_argument("--rows", type=int, default=120)
    ap.add_argument("--groups", type=int, default=40)
    ap.add_argument("--group-size", type=int, default=5)
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--lambdas", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("only --smoke is implemented as a CLI; use SGLServer "
                 "programmatically for real queues")

    plan = Plan(n_folds=args.folds, n_lambdas=args.lambdas, tol=1e-6,
                safety=1e-6, max_iter=6000, check_every=50)
    # float32, the kernels' dtype (the reference's default precision too)
    server = SGLServer(plan, device=args.device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    sizes = [args.group_size] * args.groups

    def push():
        for X, y in _synthetic_jobs(rng, args.designs, args.jobs_per_design,
                                    args.rows, args.groups,
                                    args.group_size):
            server.submit(X, y, groups=sizes)

    push()
    n_jobs = server.pending
    t0 = time.perf_counter()
    cold = server.drain()
    t_cold = time.perf_counter() - t0
    push()
    t0 = time.perf_counter()
    warm = server.drain()
    t_warm = time.perf_counter() - t0

    failed = [r for r in list(cold.values()) + list(warm.values())
              if r.error is not None]
    if failed:
        raise RuntimeError(f"job {failed[0].job_id} failed: "
                           f"{failed[0].error}")
    cold_comp = sum({r.batched_with[0]: r.new_compilations
                     for r in cold.values()}.values())
    warm_comp = sum({r.batched_with[0]: r.new_compilations
                     for r in warm.values()}.values())
    print(f"device, dtype            : {server.device}, float32")
    print(f"jobs per drain           : {n_jobs} "
          f"({args.designs} designs x {args.jobs_per_design} responses, "
          f"fold-stacked per design)")
    print(f"cold drain               : {t_cold:.2f}s total, "
          f"{t_cold / n_jobs * 1e3:.0f}ms/job, "
          f"{cold_comp} sweep compilations")
    print(f"warm drain               : {t_warm:.2f}s total, "
          f"{t_warm / n_jobs * 1e3:.0f}ms/job, "
          f"{warm_comp} sweep compilations")
    print(f"warm per-job latency     : "
          f"{np.mean([r.latency for r in warm.values()]) * 1e3:.0f}ms "
          f"(speedup {t_cold / max(t_warm, 1e-9):.2f}x)")
    sample = warm[min(warm)]
    print(f"sample job               : best_lambda={sample.best_lambda:.4f} "
          f"lambda_1se={sample.lambda_1se:.4f} "
          f"nnz={int(np.sum(np.abs(sample.coef) > 1e-8))} "
          f"batched_with={sample.batched_with}")
    return warm


if __name__ == "__main__":
    main()
