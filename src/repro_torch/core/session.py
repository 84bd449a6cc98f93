"""SGLSession — a persistent handle binding a ``Problem`` to device state
(PyTorch port of the ``.path`` verb).

The session owns one persistent set of sweep-shape keys (``compile_keys``)
threaded through every engine call, so ``EngineStats.n_compilations``
counts the shapes a run meets for the first time: a second
``session.path(plan)`` over the same buckets reports zero.

The other verbs of the reference (``cv``, ``refine``, ``stability``) are not
ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Optional

from .path_engine import EngineStats, sgl_path_batched
from .problem import Plan, Problem


class SGLSession:
    """Handle executing Plans against one Problem.

    >>> prob = Problem.sgl(X, y, groups=[10] * 150)
    >>> sess = SGLSession(prob)
    >>> path = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))
    >>> path2 = sess.path(Plan(alpha=1.0, n_lambdas=40, tol=1e-8))  # warm
    """

    def __init__(self, problem: Problem, plan: Optional[Plan] = None):
        self.problem = problem
        self.default_plan = plan if plan is not None else Plan()
        self.compile_keys: set = set()
        self.stats = EngineStats()       # aggregate over the session

    def _resolve(self, plan: Optional[Plan], overrides: dict) -> Plan:
        plan = self.default_plan if plan is None else plan
        if overrides:
            plan = plan.with_(**overrides)
        plan.validate(self.problem)
        return plan

    def path(self, plan: Optional[Plan] = None, **overrides):
        """Solve one lambda path; compiled buckets persist across calls."""
        plan = self._resolve(plan, overrides)
        prob = self.problem
        screen = plan.resolved_screen(prob.penalty)
        res = sgl_path_batched(
            prob.X, prob.y, prob.spec, plan.alpha,
            lambdas=plan.lambdas, n_lambdas=plan.n_lambdas,
            min_ratio=plan.min_ratio, screen=screen, tol=plan.tol,
            max_iter=plan.max_iter, safety=plan.safety,
            specnorm_method=plan.specnorm_method,
            check_every=plan.check_every, use_kernels=plan.use_kernels,
            min_bucket=plan.min_bucket,
            min_group_bucket=plan.min_group_bucket, margin=plan.margin,
            chunk_init=plan.chunk_init, compile_keys=self.compile_keys,
            loss=plan.resolved_loss(prob.loss))
        self.stats.merge(res.stats)
        return res
