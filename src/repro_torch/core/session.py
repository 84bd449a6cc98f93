"""SGLSession — a persistent handle binding a ``Problem`` to device state
(PyTorch port of the reference's verbs ``.path``, ``.cv``, ``.refine`` and
``.stability``).

The session owns one persistent set of sweep-shape keys (``compile_keys``)
threaded through every engine call, so ``EngineStats.n_compilations``
counts the shapes a run meets for the first time: a second call of any
verb over the same buckets reports zero.  Beside it, the session owns the
CUDA graphs of the SGL FISTA block (``fista_graphs``), captured on the card
at the first solve of each shape, so a warm call captures none.  ``X^T y``
(for a non-squared loss, ``X^T`` times the loss's residual at beta = 0)
and the per-alpha ``lambda_max`` grid anchor are computed once per
session.  Adaptive ``Plan.group_weights`` / ``Plan.feature_weights``
overlay the problem's spec for one call (``_effective``).
``Plan(engine='legacy')`` runs the paper's per-lambda driver
(``core.path``) on the effective spec, with the session's graph cache and
the plan's ``use_kernels`` (the reference's legacy route ignores
``use_pallas``: it runs no kernel); it reports no ``EngineStats``.

Model selection on top of the fold engine:

  * ``cv`` records the per-fold certified solutions (``_CVState``).
  * ``refine(around=lam, factor=10)`` rebuilds the exact per-fold duals at
    the nearest coarse grid point above the refinement window (one batched
    GEMM, ``_fold_state_at``) and seeds a finer grid from them through
    ``init=``: the warm run screens against a reference dual already near
    the window and warm-starts FISTA from the coarse optimum.  The seed
    changes each fold's first fine row only (the later rows warm-start
    from their neighbours, as in a cold CV), so it saves iterations where
    that row would take more gap checks from zero; no new compilation
    when the coarse run visited the buckets.  A window that reaches
    lambda_max is seeded at the grid's first point, each fold's clamped
    lambda_max state: the cold start.  The refined run becomes the new
    warm state, so refinements compose.
  * ``stability`` solves the grid on random row subsamples,
    ``plan.batch_size`` at a time through the fold engine, and returns the
    selection probabilities.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .cv import (CVResult, FoldState, StabilityResult, _cv_statistics,
                 _masks_from_folds, kfold_indices, nn_fold_paths,
                 per_fold_centering, sgl_fold_paths, subsample_masks)
from .dpc import dual_scaling_nn, lambda_max_nn
from .groups import GroupSpec
from .lambda_max import dual_scaling_sgl, lambda_max_sgl
from .losses import get_loss
from .path_engine import EngineStats, nn_lasso_path_batched, sgl_path_batched
from .problem import Plan, Problem


@dataclasses.dataclass
class RefineResult:
    """Outcome of a warm two-stage grid refinement (``session.refine``)."""
    coarse: CVResult             # the seeding coarse-grid CV
    fine: CVResult               # the refined-grid CV (warm-started)
    lambda_: float               # selected on the fine grid
    index: int                   # its index in fine.lambdas
    warm_start_lambda: float     # coarse grid point the duals were seeded at
    #                              (nan: no coarse point above the window)
    new_compilations: int        # sweep shapes not already in the session
    total_iters: int             # FISTA iterations summed over folds x grid


# ---------------------------------------------------------------------------
# Exact per-fold dual reconstruction (one batched GEMM per call)
# ---------------------------------------------------------------------------

def _fold_duals_sgl(X, spec, alpha, Y, masks, betas, lam_ref, mus):
    """(theta, c_theta, xty, lam_max) per fold from the certified optima
    ``betas`` (K, p) at one grid point: Lemma-9 dual scaling of the
    (masked, centered) residual recovers each fold's exact dual there, the
    algebra of the engine's own certification."""
    fit = betas @ X.T
    if mus is not None:
        fit = fit - torch.sum(betas * mus, dim=1)[:, None]
    resid = Y - masks * fit
    rho = resid / lam_ref
    c = rho @ X
    if mus is not None:
        c = c - torch.sum(rho, dim=1)[:, None] * mus
        xty = Y @ X - torch.sum(Y, dim=1)[:, None] * mus
    else:
        xty = Y @ X
    s = torch.stack([dual_scaling_sgl(spec, ck, alpha) for ck in c])
    lam_max_f = torch.stack([lambda_max_sgl(spec, ck, alpha)[0]
                             for ck in xty])
    return s[:, None] * rho, s[:, None] * c, xty, lam_max_f


def _fold_duals_nn(X, Y, masks, betas, lam_ref):
    resid = Y - masks * (betas @ X.T)
    rho = resid / lam_ref
    c = rho @ X
    xty = Y @ X
    s = torch.stack([dual_scaling_nn(ck) for ck in c])
    lam_max_f = torch.amax(xty, dim=1)
    return s[:, None] * rho, s[:, None] * c, xty, lam_max_f


@dataclasses.dataclass
class _CVState:
    """What ``refine`` needs from the last ``session.cv`` run."""
    plan: Plan
    result: CVResult
    masks: np.ndarray            # (K, N)
    y_rows: np.ndarray           # (N,) or (K, N): responses the folds saw
    mus: Optional[np.ndarray]    # (K, p) per-fold means (center="per-fold")
    y_means: Optional[np.ndarray]
    spec: Optional[GroupSpec] = None  # effective (possibly reweighted) spec


class SGLSession:
    """Handle executing Plans against one Problem.

    >>> prob = Problem.sgl(X, y, groups=[10] * 150)
    >>> sess = SGLSession(prob)
    >>> path = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))
    >>> path2 = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))  # warm
    >>> cv = sess.cv(Plan(alpha=1.0, n_lambdas=40, n_folds=5))
    >>> ref = sess.refine(factor=10)     # warm two-stage refinement
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
        self._last_cv: Optional[_CVState] = None

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
                      feature_shards=plan.feature_shards,
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
        full-data lambda_max; records the warm state for ``refine``."""
        plan = self._resolve(plan, overrides)
        prob = self.problem
        loss, spec = self._effective(plan)
        lambdas, lam_max = self._grid(plan, spec)
        folds, masks, mus, y_means, y_rows = self._fold_setup(plan)
        betas, kept, iters, stats, times = self._fold_run(
            plan, spec, loss, y_rows, masks, lambdas, mus=mus)
        res = _cv_statistics(prob.X.cpu().numpy(), prob.y.cpu().numpy(),
                             folds, np.asarray(lambdas, float), betas,
                             lam_max, kept, stats, times, iters=iters,
                             mus=mus, y_means=y_means)
        self._absorb(stats)
        self._last_cv = _CVState(plan=plan, result=res, masks=masks,
                                 y_rows=y_rows, mus=mus, y_means=y_means,
                                 spec=spec)
        return res

    def _fold_state_at(self, j_ref: int) -> FoldState:
        """Exact per-fold engine state at coarse grid point ``j_ref``,
        rebuilt from the stored certified solutions (one batched GEMM in the
        problem's dtype, read back as float64).  A fold whose own
        lambda_max sits at or below the reference is clamped to its exact
        all-zero state at that lambda_max."""
        st = self._last_cv
        prob = self.problem
        coarse = st.result
        lam_ref = float(coarse.lambdas[j_ref])
        dev, dtype = prob.device, prob.dtype

        def on_dev(a):
            return torch.as_tensor(np.array(a, dtype=float), dtype=dtype,
                                   device=dev)

        masks_d = on_dev(st.masks)
        K, N = st.masks.shape
        y_rows = np.broadcast_to(np.asarray(st.y_rows, dtype=float), (K, N))
        Y = masks_d * on_dev(y_rows)
        betas = on_dev(coarse.fold_betas[:, j_ref])
        if prob.penalty == "sgl":
            spec = st.spec if st.spec is not None else prob.spec
            mus_d = None if st.mus is None else on_dev(st.mus)
            theta, c_theta, xty, lam_max_f = _fold_duals_sgl(
                prob.X, spec, st.plan.alpha, Y, masks_d, betas, lam_ref,
                mus_d)
        else:
            theta, c_theta, xty, lam_max_f = _fold_duals_nn(
                prob.X, Y, masks_d, betas, lam_ref)
        theta = theta.cpu().numpy().astype(float)
        c_theta = c_theta.cpu().numpy().astype(float)
        xty = xty.cpu().numpy().astype(float)
        lam_max_f = lam_max_f.cpu().numpy().astype(float)
        beta0 = np.asarray(coarse.fold_betas[:, j_ref], dtype=float).copy()
        lam_bar = np.full(K, lam_ref)
        at_max = lam_ref >= lam_max_f * (1.0 - 1e-12)
        for k in np.nonzero(at_max)[0]:
            # the reference sits at/above this fold's own lambda_max: its
            # exact state there is the all-zero solution with dual y/lam
            lm = lam_max_f[k] if lam_max_f[k] > 0 else 1.0
            lam_bar[k] = lm
            theta[k] = st.masks[k] * y_rows[k] / lm
            c_theta[k] = xty[k] / lm
            beta0[k] = 0.0
        return FoldState(lam_bar=lam_bar, theta=theta, c_theta=c_theta,
                         beta=beta0)

    def _fold_run(self, plan: Plan, spec, loss, y_rows, masks, lambdas,
                  mus=None, init=None):
        """One fold-engine call under ``plan`` with the session's caches."""
        prob = self.problem
        common = dict(screen=plan.resolved_screen(prob.penalty, loss),
                      tol=plan.tol, max_iter=plan.max_iter,
                      safety=plan.safety, check_every=plan.check_every,
                      min_bucket=plan.min_bucket, margin=plan.margin,
                      chunk_init=plan.chunk_init, chunk_cap=plan.chunk_cap,
                      schedule=plan.schedule, use_kernels=plan.use_kernels,
                      mesh=plan.mesh, init=init,
                      compile_keys=self.compile_keys,
                      feature_shards=plan.feature_shards)
        if prob.penalty == "sgl":
            return sgl_fold_paths(
                prob.X, y_rows, spec, plan.alpha, masks, lambdas,
                specnorm_method=plan.specnorm_method,
                min_group_bucket=plan.min_group_bucket, mus=mus,
                fista_graphs=self.fista_graphs, loss=loss, **common)
        return nn_fold_paths(prob.X, y_rows, masks, lambdas, **common)

    def refine(self, around: Optional[float] = None, factor: float = 10.0,
               n_lambdas: Optional[int] = None,
               plan: Optional[Plan] = None, **overrides) -> RefineResult:
        """Warm two-stage grid refinement around the CV-selected lambda.

        Runs a fine grid of ``n_lambdas`` points spanning ``factor``
        (log-spaced, centered on ``around``; by default the lambda the last
        ``session.cv`` selected under the plan's selection rule), seeded
        from the coarse run's certified per-fold duals at the nearest
        coarse grid point above the window.  Returns the fine-grid
        ``CVResult`` with the warm-start accounting.
        """
        if self._last_cv is None:
            raise RuntimeError("session.refine requires a prior "
                               "session.cv(plan) on this session")
        st = self._last_cv
        base = st.plan if plan is None else plan
        plan = base.with_(**overrides) if overrides else base
        plan.validate(self.problem)
        # the warm state is exact only for the coarse run's geometry: the
        # rebuilt duals are feasible for the coarse alpha's dual set, and
        # the masks and centering are the coarse run's, so a plan that
        # changes either is refused
        changed = [f for f in ("alpha", "center", "n_folds", "seed", "loss")
                   if getattr(plan, f) != getattr(st.plan, f)]
        for f in ("folds", "group_weights", "feature_weights"):
            if getattr(plan, f) is not getattr(st.plan, f):
                changed.append(f)
        if changed:
            raise ValueError(
                f"refine cannot change {changed} (the warm per-fold state "
                f"is only exact for the coarse run's geometry); run "
                f"session.cv with the new plan instead")
        coarse = st.result
        if around is None:
            around = (coarse.best_lambda if plan.selection == "min"
                      else coarse.lambda_1se)
        if factor <= 1.0:
            raise ValueError("factor must be > 1")
        half = math.sqrt(factor)
        hi = min(around * half, coarse.lam_max * (1.0 - 1e-9))
        lo = min(around / half, hi)
        n = int(n_lambdas) if n_lambdas is not None else plan.n_lambdas
        fine = np.exp(np.linspace(math.log(hi), math.log(lo), n))

        above = np.nonzero(coarse.lambdas >= hi * (1.0 - 1e-12))[0]
        if len(above):
            j_ref = int(above[-1])     # nearest coarse point above the window
            init = self._fold_state_at(j_ref)
            warm_lam = float(coarse.lambdas[j_ref])
        else:                          # window touches lam_max: cold seed
            init, warm_lam = None, float("nan")

        prob = self.problem
        loss, spec = self._effective(plan)
        betas, kept, iters, stats, times = self._fold_run(
            plan, spec, loss, st.y_rows, st.masks, fine, mus=st.mus,
            init=init)
        fine_res = _cv_statistics(prob.X.cpu().numpy(), prob.y.cpu().numpy(),
                                  coarse.folds, fine, betas, coarse.lam_max,
                                  kept, stats, times, iters=iters,
                                  mus=st.mus, y_means=st.y_means)
        self._absorb(stats)
        # the refined run becomes the new warm state: refine() composes
        self._last_cv = _CVState(plan=plan, result=fine_res, masks=st.masks,
                                 y_rows=st.y_rows, mus=st.mus,
                                 y_means=st.y_means, spec=spec)
        idx = (fine_res.best_index if plan.selection == "min"
               else fine_res.index_1se)
        return RefineResult(
            coarse=coarse, fine=fine_res, lambda_=float(fine[idx]),
            index=idx, warm_start_lambda=warm_lam,
            new_compilations=stats.n_compilations,
            total_iters=int(np.sum(iters)))

    def stability(self, plan: Optional[Plan] = None,
                  **overrides) -> StabilityResult:
        """Selection probabilities over random row subsamples, batched
        through the fold engine with the session's caches."""
        plan = self._resolve(plan, overrides)
        prob = self.problem
        if prob.penalty != "sgl":
            raise ValueError("stability selection is implemented for the "
                             "SGL penalty")
        loss, spec = self._effective(plan)
        lambdas, _ = self._grid(plan, spec)
        masks = subsample_masks(prob.n_samples, plan.n_subsamples,
                                plan.subsample_frac, plan.seed)
        counts = np.zeros((len(lambdas), prob.n_features))
        agg = EngineStats()
        for b0 in range(0, plan.n_subsamples, plan.batch_size):
            betas, _, _, stats, _ = self._fold_run(
                plan, spec, loss, prob.y, masks[b0:b0 + plan.batch_size],
                lambdas)
            counts += (np.abs(betas) > plan.active_tol).sum(axis=0)
            agg.merge(stats, buckets=False)
        self._absorb(agg)
        probs = counts / plan.n_subsamples
        return StabilityResult(lambdas=np.asarray(lambdas, float),
                               selection_probs=probs,
                               max_probs=probs.max(axis=0),
                               n_subsamples=plan.n_subsamples, stats=agg)
