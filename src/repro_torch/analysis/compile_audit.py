"""Compile-key audit of the port: statically enumerate every sweep-shape key
and every CUDA graph a Problem/Plan can make, and hold them to an
O(log p) budget without running a solve (the counterpart of
``repro.analysis.compile_audit``).

The batched engine's shapes are bucketed: feature sets round up a pow2
ladder anchored at ``min_bucket``, group counts up a ladder anchored at
``min_group_bucket``, lambda chunks up a pow2 ladder capped by the chunk
policy.  So the number of distinct sweep shapes is a product of ladder
lengths, polylogarithmic in (p, G, J).  This module mirrors the PORT's
key tuples (``core/path_engine.py`` ``("sgl", ...)`` / ``("sgl-feat",
...)`` / ``("nn", ...)`` / ``("nn-feat", ...)`` and ``core/cv.py``
``("sgl-folds", ...)`` / ``("nn-folds", ...)``), which differ from the
reference's in one place: the feature-sharded keys carry the ``kernels``
flag as well as whether a process group runs the blocks.  The fold keys
carry the plan's fold mesh.

* ``predict_keys(shape, plan, ...)``: the universe of keys the engines
  may pay; every key a session pays must be a member
  (``verify_paid_keys``, rule ``compile/unpredicted-key``).
* ``predict_graph_keys(shape, plan, ...)``: the port's own compile.  On
  the card a float32 SGL solve replays a captured CUDA graph of its FISTA
  block, cached per ``(rows, p_b, G_b, max_size, dtype, check_every,
  loss, device)`` (``core/solver.py:fista_sgl_graphed``); what a
  compilation is to XLA, a capture is here.  Every key of a session's
  ``fista_graphs`` must be a member (``verify_paid_graphs``, rule
  ``compile/unpredicted-graph``).
* ``budget(...)``: the polylog bound; a universe above it means a key
  component stopped being bucketed (rule ``compile/budget-exceeded``).

When the engines' key tuples change, this module changes with them: that
coupling is the point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

from .findings import Finding

KINDS = ("path", "cv")
GRAPH_KINDS = ("path", "cv", "refit")


def _pow2_ceil(m: int) -> int:
    b = 1
    while b < m:
        b *= 2
    return b


def feature_buckets(p: int, min_bucket: int) -> list:
    """Values ``_feature_bucket`` can return: the pow2 ladder anchored at
    ``min_bucket`` (every value below p) plus p itself (reached by
    clipping, by the margin-doubling rule, or by the S.all() fast path)."""
    ladder = []
    b = max(int(min_bucket), 1)
    while b < p:
        ladder.append(b)
        b *= 2
    ladder.append(p)
    return ladder


def group_buckets(G: int, min_group_bucket: int) -> list:
    """Values the group-bucket ladder can take:
    ``min(_bucket(., min_group_bucket), G + 1)``.  (The single path's
    S.all() fast path's exact G is added by the caller: the fold engine
    has no such fast path.)"""
    ladder = []
    b = max(int(min_group_bucket), 1)
    while b < G + 1:
        ladder.append(b)
        b *= 2
    ladder.append(G + 1)
    return ladder


def chunk_lengths(J: int, chunk_init: int, cap: int) -> list:
    """pow2 lengths a chunk can pad to: the speculative chunk starts at
    ``chunk_init`` (uncapped), then moves within [2, cap]; the remaining
    grid bounds it as well."""
    hi = _pow2_ceil(min(J, max(int(cap), int(chunk_init), 1)))
    out, b = [], 1
    while b <= hi:
        out.append(b)
        b *= 2
    return out


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """The static dims the keys depend on (a Problem without data).
    ``dtype`` and ``device`` are the port's strings (``str(X.dtype)``,
    ``str(X.device)``): both enter its keys, and the device decides
    whether the kernels (and the graphs) run."""
    N: int
    p: int
    G: int                      # 0 for nn_lasso
    max_size: int               # 0 for nn_lasso
    penalty: str                # "sgl" | "nn_lasso"
    dtype: str                  # "torch.float32" | "torch.float64"
    loss: str = "squared"       # Problem.loss: "squared" | "logistic"
    weighted: bool = False      # spec carries adaptive feature weights
    device: str = "cpu"         # str(problem.device): "cpu", "cuda:0"

    @classmethod
    def of(cls, problem) -> "ProblemShape":
        spec = problem.spec
        return cls(N=problem.n_samples, p=problem.n_features,
                   G=spec.num_groups if spec is not None else 0,
                   max_size=spec.max_size if spec is not None else 0,
                   penalty=problem.penalty, dtype=str(problem.dtype),
                   loss=problem.loss,
                   weighted=(spec is not None
                             and spec.feature_weights is not None),
                   device=str(problem.device))


def _kernels(use_kernels, shape: ProblemShape) -> bool:
    """The engines' ``_kernels_active`` on the shape's dtype and device."""
    import torch
    from ..core.path_engine import _kernels_active
    dtype = getattr(torch, shape.dtype.split(".")[-1])
    return _kernels_active(use_kernels, dtype, shape.device)


def _grid_len(plan) -> int:
    return (len(plan.lambdas) if plan.lambdas is not None
            else int(plan.n_lambdas))


def _n_folds(plan, n_folds: Optional[int]) -> int:
    if n_folds is not None:
        return int(n_folds)
    return len(plan.folds) if plan.folds is not None else int(plan.n_folds)


def _path_shards(shape: ProblemShape, plan) -> int:
    shards = int(plan.feature_shards)
    if shards > 1:
        from ..distributed.feature_shard import effective_shards
        shards = effective_shards(
            shape.G if shape.penalty == "sgl" else shape.p, shards)
    return shards


def predict_keys(shape: ProblemShape, plan, kinds: Iterable[str] = KINDS,
                 n_folds: Optional[int] = None) -> set:
    """The universe of sweep-shape keys the engines may pay for this
    (problem shape, plan) under the given verbs: "path" (the single-path
    engine) and/or "cv" (the fold engine: cv, refine and stability;
    ``n_folds`` is the most members a launch can hold, ``plan.batch_size``
    for stability)."""
    N, p, G = shape.N, shape.p, shape.G
    J = _grid_len(plan)
    kernels = _kernels(plan.use_kernels, shape)
    loss = plan.resolved_loss(shape.loss)
    keys: set = set()
    fbs = feature_buckets(p, plan.min_bucket)
    K = _n_folds(plan, n_folds)

    if "path" in kinds:
        lens = chunk_lengths(J, plan.chunk_init, 64)   # the path's cap
        shards = _path_shards(shape, plan)
        feat = shards > 1
        common = (shape.dtype, plan.max_iter, plan.check_every)
        if shape.penalty == "sgl":
            # + exact G: the S.all() fast path keeps the parent spec
            gbs = sorted(set(group_buckets(G, plan.min_group_bucket))
                         | {G})
            for p_b in fbs:
                for g_b in gbs:
                    for len2 in lens:
                        tail = (p_b, g_b, shape.max_size, len2, loss)
                        if feat:
                            # whether a process group runs the blocks
                            # depends on the world: predict both
                            for on_group in (False, True):
                                keys.add(("sgl-feat", shards, N, p, G)
                                         + common + (on_group, kernels)
                                         + tail)
                        else:
                            keys.add(("sgl", N, p, G) + common
                                     + (kernels,) + tail)
        else:
            for p_b in fbs:
                for len2 in lens:
                    tail = (p_b, len2, "squared")
                    if feat:
                        for on_group in (False, True):
                            keys.add(("nn-feat", shards, N, p) + common
                                     + (on_group, kernels) + tail)
                    else:
                        keys.add(("nn", N, p) + common + (kernels,) + tail)

    if "cv" in kinds and loss == "squared":
        # the fold engine refuses a loss whose masked rows do not vanish
        lens = chunk_lengths(J, plan.chunk_init, plan.chunk_cap)
        centered = plan.center == "per-fold"
        common = (shape.dtype, plan.max_iter, plan.check_every, plan.mesh)
        if shape.penalty == "sgl":
            gbs = group_buckets(G, plan.min_group_bucket)
            for Ka in range(1, K + 1):
                for p_b in fbs:
                    for g_b in gbs:
                        for len2 in lens:
                            keys.add(("sgl-folds", Ka, N, p, G) + common
                                     + (p_b, g_b, shape.max_size, len2,
                                        centered, kernels, loss))
        else:
            for Ka in range(1, K + 1):
                for p_b in fbs:
                    for len2 in lens:
                        keys.add(("nn-folds", Ka, N, p) + common
                                 + (p_b, len2, kernels, "squared"))
    return keys


def predict_graph_keys(shape: ProblemShape, plan,
                       kinds: Iterable[str] = GRAPH_KINDS) -> set:
    """The universe of captured FISTA graphs (``solver.fista_sgl_graphed``
    cache keys) for this (problem shape, plan): empty unless an SGL
    problem runs float32 on the card with the kernels on and no feature
    weights.  "path": the batched engine's buckets (the per-lambda
    driver's under ``engine='legacy'``, and the full design under
    ``screen='none'``); "cv": the fold engine's; "refit": the estimators'
    and the server's full-design solves at ``check_every=10``."""
    if (shape.penalty != "sgl" or shape.weighted
            or plan.feature_weights is not None
            or not shape.device.startswith("cuda")
            or shape.dtype != "torch.float32"):
        return set()
    N, p, G = shape.N, shape.p, shape.G
    loss = plan.resolved_loss(shape.loss)

    def key(p_b, g_b, check_every):
        return (N, p_b, g_b, shape.max_size, shape.dtype, check_every, loss,
                shape.device)

    keys: set = set()
    on = _kernels(plan.use_kernels, shape)
    if "path" in kinds and on:
        if plan.engine == "legacy":
            # the per-lambda driver: _bucket(kept) from 64, group buckets
            # from 16, and the full design for an unscreened row
            shapes = [(p_b, g_b) for p_b in feature_buckets(p, 64)
                      for g_b in group_buckets(G, 16)] + [(p, G)]
        else:
            shapes = [(p_b, g_b) for p_b in feature_buckets(p,
                                                            plan.min_bucket)
                      for g_b in sorted(set(group_buckets(
                          G, plan.min_group_bucket)) | {G})]
        keys.update(key(p_b, g_b, plan.check_every) for p_b, g_b in shapes)
    if "cv" in kinds and on and loss == "squared":
        keys.update(key(p_b, g_b, plan.check_every)
                    for p_b in feature_buckets(p, plan.min_bucket)
                    for g_b in group_buckets(G, plan.min_group_bucket))
    if "refit" in kinds:
        # solve_sgl(use_kernels=True) on the full design, check_every 10
        keys.add(key(p, G, 10))
    return keys


def budget(shape: ProblemShape, plan, kinds=KINDS,
           n_folds: Optional[int] = None) -> int:
    """Polylog bound on the key universe's size: the product of the three
    ladder lengths (features, groups, chunks), times the fold cohort
    sizes for "cv".  O(K log p log G log J)."""
    p, G = shape.p, shape.G
    J = _grid_len(plan)
    lf = math.floor(math.log2(max(p, 2))) + 2
    lg = (math.floor(math.log2(max(G + 1, 2))) + 3
          if shape.penalty == "sgl" else 1)
    lc = math.floor(math.log2(max(min(J, 64), 2))) + 2
    total = 0
    if "path" in kinds:
        # sharded path keys carry the process-group flag (2 values)
        feat_mult = 2 if int(plan.feature_shards) > 1 else 1
        total += lf * lg * lc * feat_mult
    if "cv" in kinds:
        total += _n_folds(plan, n_folds) * lf * lg * lc
    return total


def audit(shape: ProblemShape, plan, kinds=KINDS,
          n_folds: Optional[int] = None, label: str = "") -> list:
    """Static findings for one configuration: the key universe and the
    graph universe against the polylog budget."""
    bound = budget(shape, plan, kinds, n_folds)
    loc = label or (f"{shape.penalty}[{shape.dtype}] N={shape.N} "
                    f"p={shape.p} G={shape.G}")
    findings = []
    for what, universe in (
            ("compile-key", predict_keys(shape, plan, kinds, n_folds)),
            ("graph", predict_graph_keys(shape, plan,
                                         tuple(kinds) + ("refit",)))):
        if len(universe) > bound:
            findings.append(Finding(
                "compile/budget-exceeded", "error", f"{loc}:{what}",
                f"predicted {what} universe has {len(universe)} keys, "
                f"above the polylog budget {bound}: a key component is no "
                f"longer bucketed (data-dependent shapes leaked into the "
                f"cache)"))
    return findings


def verify_paid_keys(paid: Iterable[tuple], universe: set,
                     label: str = "run") -> list:
    """Every sweep-shape key a session paid must have been predicted."""
    return [Finding(
        "compile/unpredicted-key", "error", f"{label}:{key[0]}",
        f"engine paid compile key {key!r} that the static audit did not "
        f"predict: predict_keys has drifted from the engine's key "
        f"construction") for key in paid if key not in universe]


def verify_paid_graphs(paid: Iterable[tuple], universe: set,
                       label: str = "run") -> list:
    """Every CUDA graph a session captured (the keys of its
    ``fista_graphs``) must have been predicted."""
    return [Finding(
        "compile/unpredicted-graph", "error", f"{label}:{key[1]}x{key[2]}",
        f"a FISTA graph was captured under key {key!r}, which the static "
        f"audit did not predict: predict_graph_keys has drifted from the "
        f"solver's cache key") for key in paid if key not in universe]


def run() -> list:
    """The audit's entry: representative configurations (both penalties
    x dtypes x centering, a feature-sharded plan, the per-lambda driver
    and a fold mesh of two ranks, on the card's device string so that the
    graph universe is enumerated).  Static: nothing runs on a device."""
    from ..core.problem import Plan
    from ..launch.mesh import FoldMesh

    findings = []
    base = Plan(n_lambdas=40, n_folds=4)
    shapes = [
        ProblemShape(N=100, p=500, G=50, max_size=10, penalty="sgl",
                     dtype=f"torch.float{bits}", device="cuda:0")
        for bits in (64, 32)] + [
        ProblemShape(N=80, p=300, G=0, max_size=0, penalty="nn_lasso",
                     dtype="torch.float64")]
    plans = [("default", base),
             ("per-fold", base.with_(center="per-fold")),
             ("big-chunk", base.with_(chunk_init=32, chunk_cap=128)),
             ("feat8", base.with_(feature_shards=8)),
             ("legacy", base.with_(engine="legacy")),
             ("fold-mesh", base.with_(mesh=FoldMesh(
                 ("fold",), {"fold": 2}, (0, 1), {"fold": 0})))]
    for shape in shapes:
        for pname, plan in plans:
            if shape.penalty == "nn_lasso" and plan.center == "per-fold":
                continue
            findings.extend(audit(
                shape, plan,
                label=f"{shape.penalty}[{shape.dtype}]/{pname}"))
    # the loss is a key dimension: a logistic problem (Gap-Safe, path
    # only) stays inside the same budget
    logit = ProblemShape(N=100, p=500, G=50, max_size=10, penalty="sgl",
                         dtype="torch.float32", loss="logistic",
                         device="cuda:0")
    findings.extend(audit(logit, base.with_(screen="gapsafe"),
                          kinds=("path",), label="sgl[logistic]/gapsafe"))
    return findings
