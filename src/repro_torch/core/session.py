"""SGLSession — a persistent handle binding a ``Problem`` to device state
(PyTorch port of the ``.path`` and ``.cv`` verbs).

The session owns one persistent set of sweep-shape keys (``compile_keys``)
threaded through every engine call, so ``EngineStats.n_compilations``
counts the shapes a run meets for the first time: a second
``session.path(plan)`` or ``session.cv(plan)`` over the same buckets reports
zero.  Beside it, the session owns the CUDA graphs of the SGL FISTA block
(``fista_graphs``), captured on the card at the first solve of each shape,
so a warm call captures none.  ``X^T y`` (for a non-squared loss, ``X^T``
times the loss's residual at beta = 0) and the per-alpha ``lambda_max``
grid anchor are computed once per session.  Adaptive ``Plan.group_weights``
/ ``Plan.feature_weights`` overlay the problem's spec for one call
(``_effective``).  ``Plan(engine='legacy')`` runs the paper's per-lambda
driver (``core.path``) on the effective spec, with the session's graph
cache and the plan's ``use_kernels`` (the reference's legacy route ignores
``use_pallas``: it runs no kernel); it reports no ``EngineStats``.

``refine`` and ``stability`` are not ported yet (ROADMAP queue 1, items 21
and 22).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .cv import (CVResult, _cv_statistics, _masks_from_folds, kfold_indices,
                 nn_fold_paths, per_fold_centering, sgl_fold_paths)
from .dpc import lambda_max_nn
from .lambda_max import lambda_max_sgl
from .losses import get_loss
from .path_engine import EngineStats, nn_lasso_path_batched, sgl_path_batched
from .problem import Plan, Problem


class SGLSession:
    """Handle executing Plans against one Problem.

    >>> prob = Problem.sgl(X, y, groups=[10] * 150)
    >>> sess = SGLSession(prob)
    >>> path = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))
    >>> path2 = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))  # warm
    >>> cv = sess.cv(Plan(alpha=1.0, n_lambdas=40, n_folds=5))
    """

    def __init__(self, problem: Problem, plan: Optional[Plan] = None):
        self.problem = problem
        self.default_plan = plan if plan is not None else Plan()
        self.compile_keys: set = set()
        self.fista_graphs: dict = {}     # captured FISTA blocks (card)
        self.stats = EngineStats()       # aggregate over the session
        self._lam_max_cache: dict = {}   # grid-anchor cache (see lambda_max)
        # the grid anchor correlates X with the loss's residual at beta = 0
        # (y for squared loss, y - 1/2 for logistic)
        self._xty = problem.X.T @ get_loss(problem.loss).residual_at_zero(
            problem.y)

    def _resolve(self, plan: Optional[Plan], overrides: dict) -> Plan:
        plan = self.default_plan if plan is None else plan
        if overrides:
            plan = plan.with_(**overrides)
        plan.validate(self.problem)
        return plan

    def _absorb(self, stats: EngineStats) -> None:
        # buckets=False: the session aggregate lives as long as the
        # session, so per-segment bucket tuples would pile up without bound
        self.stats.merge(stats, buckets=False)

    def _effective(self, plan: Plan):
        """(loss name, effective GroupSpec) for this plan.  Adaptive
        ``plan.group_weights`` / ``plan.feature_weights`` overlay the
        problem's spec; with neither set the problem's spec object is
        returned unchanged."""
        loss = plan.resolved_loss(self.problem.loss)
        spec = self.problem.spec
        if spec is None:
            return loss, None
        return loss, spec.reweighted(plan.group_weights,
                                     plan.feature_weights)

    def lambda_max(self, alpha: float = 1.0) -> float:
        """Full-data grid anchor, cached per alpha on the session's
        ``X^T y``."""
        if self.problem.penalty == "nn_lasso":
            key = "nn"
            if key not in self._lam_max_cache:
                self._lam_max_cache[key] = float(lambda_max_nn(self._xty)[0])
            return self._lam_max_cache[key]
        alpha = float(alpha)
        if alpha not in self._lam_max_cache:
            self._lam_max_cache[alpha] = float(lambda_max_sgl(
                self.problem.spec, self._xty, alpha)[0])
        return self._lam_max_cache[alpha]

    def _grid(self, plan: Plan, spec=None):
        """(lambdas, lam_max): an explicit grid is anchored at its largest
        value, as in the reference.  ``spec`` (default: the problem's)
        anchors a reweighted plan at ITS lambda_max; the per-alpha cache
        serves only the problem's own spec."""
        if plan.lambdas is not None:
            lambdas = np.asarray(plan.lambdas, dtype=float)
            return lambdas, float(lambdas.max())
        if spec is None or spec is self.problem.spec:
            lam_max = self.lambda_max(plan.alpha)
        else:
            lam_max = float(lambda_max_sgl(spec, self._xty, plan.alpha)[0])
        if self.problem.penalty == "nn_lasso" and lam_max <= 0:
            raise ValueError("max_i <x_i, y> <= 0: nonnegative Lasso "
                             "solution is identically zero")
        return plan.grid(lam_max), lam_max

    def path(self, plan: Optional[Plan] = None, **overrides):
        """Solve one lambda path; compiled buckets persist across calls."""
        plan = self._resolve(plan, overrides)
        prob = self.problem
        loss, spec = self._effective(plan)
        screen = plan.resolved_screen(prob.penalty, loss)
        if plan.engine == "legacy":
            from .path import _nn_lasso_path_legacy, _sgl_path_legacy
            legacy = dict(lambdas=plan.lambdas, n_lambdas=plan.n_lambdas,
                          min_ratio=plan.min_ratio, screen=screen,
                          tol=plan.tol, max_iter=plan.max_iter,
                          safety=plan.safety, check_every=plan.check_every,
                          use_kernels=plan.use_kernels)
            if prob.penalty == "sgl":
                return _sgl_path_legacy(
                    prob.X, prob.y, spec, plan.alpha,
                    specnorm_method=plan.specnorm_method,
                    graphs=self.fista_graphs, **legacy)
            return _nn_lasso_path_legacy(prob.X, prob.y, **legacy)
        common = dict(lambdas=plan.lambdas, n_lambdas=plan.n_lambdas,
                      min_ratio=plan.min_ratio, screen=screen, tol=plan.tol,
                      max_iter=plan.max_iter, safety=plan.safety,
                      check_every=plan.check_every,
                      use_kernels=plan.use_kernels,
                      min_bucket=plan.min_bucket, margin=plan.margin,
                      chunk_init=plan.chunk_init,
                      compile_keys=self.compile_keys)
        if prob.penalty == "sgl":
            res = sgl_path_batched(
                prob.X, prob.y, spec, plan.alpha,
                specnorm_method=plan.specnorm_method,
                min_group_bucket=plan.min_group_bucket,
                fista_graphs=self.fista_graphs, loss=loss, **common)
        else:
            res = nn_lasso_path_batched(prob.X, prob.y, **common)
        self._absorb(res.stats)
        return res

    def _fold_setup(self, plan: Plan):
        """(folds, masks, mus, y_means, y_rows) for this plan's CV, on the
        host in float64."""
        prob = self.problem
        N = prob.n_samples
        folds = (plan.folds if plan.folds is not None
                 else kfold_indices(N, plan.n_folds, plan.seed))
        masks = _masks_from_folds(folds, N)
        y_np = prob.y.cpu().numpy().astype(float)
        if plan.center == "per-fold":
            mus, y_means, y_rows = per_fold_centering(
                prob.X.cpu().numpy().astype(float), y_np, masks)
        else:
            mus = y_means = None
            y_rows = y_np
        return folds, masks, mus, y_means, y_rows

    def cv(self, plan: Optional[Plan] = None, **overrides) -> CVResult:
        """Fold-batched K-fold CV over the plan's grid, anchored at the
        full-data lambda_max."""
        plan = self._resolve(plan, overrides)
        prob = self.problem
        loss, spec = self._effective(plan)
        screen = plan.resolved_screen(prob.penalty, loss)
        lambdas, lam_max = self._grid(plan, spec)
        folds, masks, mus, y_means, y_rows = self._fold_setup(plan)
        common = dict(screen=screen, tol=plan.tol, max_iter=plan.max_iter,
                      safety=plan.safety, check_every=plan.check_every,
                      min_bucket=plan.min_bucket, margin=plan.margin,
                      chunk_init=plan.chunk_init, chunk_cap=plan.chunk_cap,
                      schedule=plan.schedule, use_kernels=plan.use_kernels,
                      mesh=plan.mesh, compile_keys=self.compile_keys,
                      feature_shards=plan.feature_shards)
        if prob.penalty == "sgl":
            betas, kept, iters, stats, times = sgl_fold_paths(
                prob.X, y_rows, spec, plan.alpha, masks, lambdas,
                specnorm_method=plan.specnorm_method,
                min_group_bucket=plan.min_group_bucket, mus=mus,
                fista_graphs=self.fista_graphs, loss=loss, **common)
        else:
            betas, kept, iters, stats, times = nn_fold_paths(
                prob.X, y_rows, masks, lambdas, **common)
        res = _cv_statistics(prob.X.cpu().numpy(), prob.y.cpu().numpy(),
                             folds, np.asarray(lambdas, float), betas,
                             lam_max, kept, stats, times, iters=iters,
                             mus=mus, y_means=y_means)
        self._absorb(stats)
        return res

    def refine(self, *args, **kwargs):
        raise NotImplementedError(
            "SGLSession.refine is not ported yet (ROADMAP queue 1, item 21)")

    def stability(self, *args, **kwargs):
        raise NotImplementedError(
            "SGLSession.stability is not ported yet (ROADMAP queue 1, "
            "item 22)")
