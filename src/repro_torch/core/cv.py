"""Fold-batched K-fold cross-validation on the batched engine (PyTorch port
of the single-device engine of ``repro.core.cv``).

K-fold CV solves the SAME lambda grid on K row subsets of one design:

  * **Masked-row embedding.**  Fold k's training problem is the full-size
    problem with its held-out rows zeroed: every per-fold vector (response,
    dual iterate, normal direction, residual) lives on the full row index
    with zeros at the held-out rows.  Zero rows add nothing to any inner
    product, so the masked algebra is the per-fold algebra, and every fold
    shares the one (N, p) design.

  * **Fold-batched grid screening.**  At each scheduler step the ready
    folds' ball geometries are stacked into a single ``(K*L, N) x (N, p)``
    GEMM against the shared design (``tlfre_screen_grid_folds`` /
    ``dpc_screen_grid_folds``).  ``EngineStats.n_screens`` counts these
    stacked GEMMs, one per scheduler step.  On float32 problems the
    reductions after the GEMM run through the fold-stack kernels
    (``screen_norms_folds`` / ``dpc_screen_folds``), counted in
    ``EngineStats.n_pallas_screens``; float64 runs never engage them, nor
    do adaptive feature weights.  ``screen='gapsafe'`` intersects each
    fold's screen with the Gap-Safe ball around its latest certified dual:
    GEMV-sized work, and for SGL one more ``screen_norms_folds`` launch of
    K rows per stacked screen.

  * **Fold sweeps.**  A launch takes a cohort of folds on one common
    feature bucket.  The reference vmaps the single-fold sweep over the
    cohort; each member's result is that of a single-fold sweep on its own
    subproblem.  Here each member's sweep runs through ``sweep_sgl_core`` /
    ``sweep_nn_core``, one after another, and its certificates are padded
    with False to the launch's pow2 chunk length.  Every accepted row still
    certifies against its fold's full training problem.

  * **The fold mesh** (``mesh=``, ``launch.mesh.make_fold_mesh`` or
    ``make_fold_feature_mesh``) splits each launch's members across the
    ranks of its 'fold' axis when the axis size divides the cohort
    (``fold_shard_compatible``, checked for every launch, as elastic
    cohorts change size); one ``all_gather`` then gives every rank the
    whole cohort's outputs.  A cohort the axis does not divide runs whole
    on every rank, with no collective.  Only the FISTA sweeps are split:
    every rank builds the whole cohort's sub-designs and spectral norms,
    computes the same screens from the same inputs and takes every
    decision from data all ranks hold, so all ranks run one schedule.

  * **Elastic fold scheduling** (``schedule='elastic'``, the default):
    every fold carries its own speculative chunk length, and ready folds
    are grouped into cohorts of like chunk length, each its own launch.
    A launch of this port has finished when it returns, so the harvest
    takes the oldest launch (the reference prefers one whose device results
    are ready).  ``schedule='lockstep'`` runs one cohort of every ready fold
    per step with one shared chunk length.

  * **Warm fold states.**  ``init=`` (a ``FoldState``: per-fold reference
    lambda, exact dual, its correlation and the primal optimum) seeds the
    engine's warm-start chain in place of each fold's lambda_max state;
    ``SGLSession.refine`` builds one from a coarse CV.  The engine keeps
    that chain on the host in float64, so loading it is a copy.

  * **Stability selection.**  ``subsample_masks`` draws random row
    subsamples; the fold drivers solve the grid on them as on folds
    (``SGLSession.stability``, and the ``stability_selection`` shim).

  * **Feature sharding** (``feature_shards > 1``) runs the stacked grid
    screens over a group-aligned column partition of X
    (``distributed.feature_shard``), one block at a time or one block a
    rank; the per-fold statistics and the sweeps keep the full-X algebra,
    so the sharded route certifies against the same numbers.  The
    fold-stack kernels run on each block.

A loss whose masked rows do not vanish (logistic) is refused with
``NotImplementedError``, as in the reference.  ``sgl_cv``,
``nn_lasso_cv`` and ``stability_selection`` are the reference's legacy
shims over ``SGLSession.cv`` and ``SGLSession.stability``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..launch.mesh import (fold_shard_compatible, run_unsharded,
                           shard_over_folds)
from .dpc import dpc_screen_grid_folds, dpc_screen_grid_folds_feat
from .fenchel import sgl_penalty, shrink
from .groups import GroupSpec, group_sum
from .lambda_max import lambda_max_sgl
from .linalg import group_spectral_norms, spectral_norm
from .losses import SQUARED, get_loss
from .path import _bucket
from .path_engine import (EngineStats, _expand_set, _feature_bucket,
                          _feature_plan, _kernels_active, _pow2_len,
                          _refuse_tf32, _sync,
                          margin_fill_nn, margin_fill_sgl, sweep_nn_core,
                          sweep_sgl_core)
from .screening import (_require_f32_for_pallas, gap_safe_grid_radii,
                        gap_safe_screen_grid_folds,
                        gap_safe_screen_grid_folds_feat,
                        tlfre_screen_grid_folds, tlfre_screen_grid_folds_feat)

SCHEDULES = ("elastic", "lockstep")


# ---------------------------------------------------------------------------
# Fold bookkeeping
# ---------------------------------------------------------------------------

def kfold_indices(n_samples: int, n_folds: int, seed: int = 0):
    """Deterministic shuffled K-fold split: a list of ``(train_idx,
    val_idx)`` pairs.  Validation sets are disjoint, cover
    ``range(n_samples)`` and differ in size by at most one; numpy's
    generator makes them the reference's folds, index for index."""
    if not 2 <= n_folds <= n_samples:
        raise ValueError(f"need 2 <= n_folds <= n_samples, got "
                         f"{n_folds} / {n_samples}")
    perm = np.random.default_rng(seed).permutation(n_samples)
    sizes = np.full(n_folds, n_samples // n_folds, dtype=int)
    sizes[: n_samples % n_folds] += 1
    folds = []
    off = 0
    for s in sizes:
        val = np.sort(perm[off:off + s])
        off += s
        train = np.setdiff1d(np.arange(n_samples), val)
        folds.append((train, val))
    return folds


def subsample_masks(n_samples: int, n_subsamples: int, frac: float = 0.5,
                    seed: int = 0) -> np.ndarray:
    """(B, N) 0/1 masks of random row subsamples (stability selection);
    numpy's generator makes them the reference's, row for row."""
    rng = np.random.default_rng(seed)
    m = max(1, int(round(frac * n_samples)))
    masks = np.zeros((n_subsamples, n_samples))
    for b in range(n_subsamples):
        masks[b, rng.choice(n_samples, m, replace=False)] = 1.0
    return masks


def _masks_from_folds(folds, n_samples: int) -> np.ndarray:
    masks = np.zeros((len(folds), n_samples))
    for k, (train, _) in enumerate(folds):
        masks[k, train] = 1.0
    return masks


def per_fold_centering(X_np, y_np, masks):
    """Leakage-free per-fold centering statistics on the masked embedding:
    ``(mus (K, p), y_means (K,), y_rows (K, N))``, each fold's train-row
    column means, response mean, and the response centered by its own
    fold mean (host float64)."""
    n_train = masks.sum(axis=1)
    mus = (masks @ X_np) / n_train[:, None]
    y_means = (masks @ y_np) / n_train
    return mus, y_means, y_np[None, :] - y_means[:, None]


@dataclasses.dataclass
class CVResult:
    lambdas: np.ndarray          # (J,) common grid (shared across folds)
    fold_betas: np.ndarray       # (K, J, p) per-fold solutions on the grid
    mse_path: np.ndarray         # (K, J) held-out MSE per fold
    mean_mse: np.ndarray         # (J,)
    se_mse: np.ndarray           # (J,) standard error over folds
    best_index: int              # argmin of mean_mse
    best_lambda: float
    index_1se: int               # largest lambda within 1 SE of the min
    lambda_1se: float
    folds: list                  # [(train_idx, val_idx)] actually used
    lam_max: float               # full-data lambda_max (grid anchor)
    kept_features: np.ndarray    # (K, J) solver columns per fold/lambda
    stats: EngineStats
    screen_time: float
    solve_time: float
    setup_time: float
    fold_iters: np.ndarray = None  # (K, J) FISTA iterations per fold/lambda

    @property
    def total_time(self):
        return self.screen_time + self.solve_time + self.setup_time


@dataclasses.dataclass
class FoldState:
    """Exact per-fold warm state at a reference lambda (one row per fold):
    the carry the fold engine threads between segments, exported so
    ``SGLSession.refine`` can seed a second, finer grid from a coarse run's
    certified duals instead of starting again from lambda_max."""
    lam_bar: np.ndarray          # (K,) reference lambda per fold
    theta: np.ndarray            # (K, N) exact dual at lam_bar, masked
    c_theta: np.ndarray          # (K, p) X_train^T theta (centered design)
    beta: np.ndarray             # (K, p) primal optimum at lam_bar


@dataclasses.dataclass
class StabilityResult:
    lambdas: np.ndarray          # (J,)
    selection_probs: np.ndarray  # (J, p) P[feature active] over subsamples
    max_probs: np.ndarray        # (p,) max over the grid (Meinshausen-
    #                              Buhlmann stable set score)
    n_subsamples: int
    stats: EngineStats


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)


# ---------------------------------------------------------------------------
# Fold-batched screens (one stacked GEMM per call)
# ---------------------------------------------------------------------------

def _boundary_normals(Y, lam_bars, lam_maxs, theta_bars, n_bound):
    """Theorem-12/21 normal per fold: the boundary normal at the fold's own
    lambda_max, else ``y/lam_bar - theta_bar``."""
    at_max = (lam_bars >= lam_maxs * (1.0 - 1e-12))[:, None]
    return torch.where(at_max, n_bound, Y / lam_bars[:, None] - theta_bars)


def _screen_folds_sgl(X, Y, spec, alpha, rem, lam_bars, lam_maxs, theta_bars,
                      n_bound, beta_prev, c_prev, masks, col_n_f, gspec_f,
                      safety, mus, *, screen: str, use_kernels: bool):
    """Stacked TLFre (+ optional Gap-Safe) screen for K folds x L lambdas:
    exactly one ``(K*L, N) x (N, p)`` GEMM.  The Gap-Safe intersection adds
    GEMV-sized work: each fold's ball center ``c_prev`` (K, p), the
    correlation of its latest certified dual, is fixed across the grid, and
    its radii come from the fold's latest certified ``beta_prev`` (K, p).
    ``mus`` (None, or (K, p) per-fold column means) applies the centering
    rank-one corrections.  Returns feat_keep (K, L, p)."""
    n_vecs = _boundary_normals(Y, lam_bars, lam_maxs, theta_bars, n_bound)
    _, fk, _ = tlfre_screen_grid_folds(X, Y, spec, alpha, rem, theta_bars,
                                       n_vecs, col_n_f, gspec_f,
                                       safety=safety, mus=mus,
                                       use_kernels=use_kernels)
    if screen == "gapsafe":
        fit = beta_prev @ X.T
        if mus is not None:     # centered fit: (X - 1 mu^T) beta
            fit = fit - torch.sum(beta_prev * mus, dim=1)[:, None]
        resid = Y - masks * fit
        pen = torch.stack([sgl_penalty(spec, b, alpha) for b in beta_prev])
        radii = gap_safe_grid_radii(Y, rem, theta_bars, resid,
                                    pen) * (1.0 + safety)
        _, fk_dyn = gap_safe_screen_grid_folds(spec, alpha, c_prev, radii,
                                               col_n_f, gspec_f,
                                               use_kernels=use_kernels)
        fk = fk & fk_dyn
    return fk


def _screen_folds_nn(X, Y, rem, lam_bars, lam_maxs, theta_bars, n_bound,
                     beta_prev, c_prev, masks, col_n_f, safety, *,
                     screen: str, use_kernels: bool):
    """Stacked DPC (+ optional Gap-Safe) screen; one GEMM for all folds.
    Returns (K, L, p)."""
    n_vecs = _boundary_normals(Y, lam_bars, lam_maxs, theta_bars, n_bound)
    fk, _ = dpc_screen_grid_folds(X, Y, rem, theta_bars, n_vecs, col_n_f,
                                  safety=safety, use_kernels=use_kernels)
    if screen == "gapsafe":
        resid = Y - masks * (beta_prev @ X.T)
        pen = torch.sum(beta_prev, dim=1)         # beta >= 0 => l1 = sum
        radii = gap_safe_grid_radii(Y, rem, theta_bars, resid,
                                    pen) * (1.0 + safety)
        # gap_safe_screen_grid_nn of every fold at once
        fk = fk & (c_prev[:, None, :] + radii[:, :, None]
                   * col_n_f[:, None, :] >= 1.0)
    return fk


def _screen_folds_sgl_feat(fops, Xs, Y, spec, specs_s, alpha, rem, lam_bars,
                           lam_maxs, theta_bars, n_bound, beta_prev, beta_s,
                           c_prev_s, masks, col_n_sf, gspec_sf, safety,
                           mus_s, *, screen: str, use_kernels: bool):
    """Feature-sharded ``_screen_folds_sgl``: the (K*L, N) x (N, p) screen
    GEMM runs block by block (no collective); the Gap-Safe intersection's
    fit is one sum across the blocks.  The penalty uses the full
    ``beta_prev`` with the global spec (O(K p), no X), so the radii are the
    unsharded screen's.  Returns feat_keep (n_local, K, L, p_shard)."""
    from ..distributed.feature_shard import sharded_fit
    n_vecs = _boundary_normals(Y, lam_bars, lam_maxs, theta_bars, n_bound)
    _, fk_s, _ = tlfre_screen_grid_folds_feat(
        fops, Xs, specs_s, Y, alpha, rem, theta_bars, n_vecs, col_n_sf,
        gspec_sf, safety=safety, mus_s=mus_s, use_kernels=use_kernels)
    if screen == "gapsafe":
        if mus_s is None:
            fit = sharded_fit(fops, Xs, beta_s)
        else:
            def body(loc):
                Xb, bb, mub = loc
                return bb @ Xb.T, torch.sum(bb * mub, dim=1)
            fit, corr = fops.fsum(body, (Xs, beta_s, mus_s))
            fit = fit - corr[:, None]
        resid = Y - masks * fit
        pen = torch.stack([sgl_penalty(spec, b, alpha) for b in beta_prev])
        radii = gap_safe_grid_radii(Y, rem, theta_bars, resid,
                                    pen) * (1.0 + safety)
        _, fk_dyn_s = gap_safe_screen_grid_folds_feat(
            fops, specs_s, alpha, c_prev_s, radii, col_n_sf, gspec_sf,
            use_kernels=use_kernels)
        fk_s = fk_s & fk_dyn_s
    return fk_s


def _screen_folds_nn_feat(fops, Xs, Y, rem, lam_bars, lam_maxs, theta_bars,
                          n_bound, beta_prev, beta_s, c_prev_s, masks,
                          col_n_sf, safety, *, screen: str,
                          use_kernels: bool):
    """Feature-sharded ``_screen_folds_nn``.  Returns (n_local, K, L,
    p_shard)."""
    from ..distributed.feature_shard import sharded_fit
    n_vecs = _boundary_normals(Y, lam_bars, lam_maxs, theta_bars, n_bound)
    fk_s, _ = dpc_screen_grid_folds_feat(fops, Xs, Y, rem, theta_bars,
                                         n_vecs, col_n_sf, safety=safety,
                                         use_kernels=use_kernels)
    if screen == "gapsafe":
        resid = Y - masks * sharded_fit(fops, Xs, beta_s)
        pen = torch.sum(beta_prev, dim=1)         # beta >= 0 => l1 = sum
        radii = gap_safe_grid_radii(Y, rem, theta_bars, resid,
                                    pen) * (1.0 + safety)

        def body(loc, radii):
            ct, cn = loc
            return ct[:, None, :] + radii[:, :, None] * cn[:, None, :] >= 1.0

        fk_s = fk_s & fops.fmap(body, (c_prev_s, col_n_sf), radii)
    return fk_s


# ---------------------------------------------------------------------------
# Fold sweeps: each member of a cohort through the single-fold sweep, the
# members split across the fold mesh
# ---------------------------------------------------------------------------

_SGL_SWEEP_AXES = (None, 0, 0, None, 0, None, 0, 0, 0, 0, None, 0)
_NN_SWEEP_AXES = (None, 0, 0, 0, 0, 0, 0, None, 0)


def _fold_sweep(kind: str, mesh, n_folds: int, max_iter: int,
                check_every: int, use_kernels: bool, *, graphs,
                centered: bool = False, loss=SQUARED):
    """The fold-batched sweep of one cohort launch of ``n_folds`` members.
    ``graphs`` is the session's cache of captured SGL FISTA blocks
    (``None`` for the nonnegative Lasso, which has no graphed route).

    Returns ``run(X, X_subs, Ys, ..., mus)`` that runs each member's sweep
    through the single-fold core (``sweep_sgl_core`` or ``sweep_nn_core``)
    and returns, per member, ``(betas, thetas, cthetas, good, iters)``: the
    rows it ran, with ``good`` (bool) and ``iters`` padded to the launch's
    chunk length with False and 0, as the reference's dead rows are.
    ``run`` takes the reference's argument order, so ``_SGL_SWEEP_AXES`` /
    ``_NN_SWEEP_AXES`` (and axis 0 for ``mus`` when ``centered``) mark its
    member-batched arguments.  Over a ``mesh`` whose fold axis divides the
    cohort, ``run`` splits the members across it
    (``launch.mesh.shard_over_folds``); over one that does not, every rank
    runs them all (``launch.mesh.run_unsharded``)."""
    kw = dict(max_iter=max_iter, check_every=check_every,
              use_kernels=use_kernels)

    def pad(good, iters, len2):
        g = np.zeros(len2, dtype=bool)
        g[:len(good)] = good
        it = np.zeros(len2, dtype=np.int64)
        it[:len(iters)] = iters
        return g, it

    if kind == "sgl":
        def run(X, X_subs, Ys, spec, sub_specs, alpha, L_subs, lam_pads,
                valids, beta0s, tol, gap_scales, mus=None):
            out = []
            for t, sub_spec in enumerate(sub_specs):
                b, th, ct, good, its = sweep_sgl_core(
                    X, X_subs[t], Ys[t], spec, sub_spec, alpha, L_subs[t],
                    lam_pads[t], valids[t], beta0s[t], tol,
                    float(gap_scales[t]), None if mus is None else mus[t],
                    graphs=graphs, loss=loss, **kw)
                out.append((b, th, ct) + pad(good, its, len(valids[t])))
            return out
    else:
        def run(X, X_subs, Ys, L_subs, lam_pads, valids, beta0s, tol,
                gap_scales):
            out = []
            for t in range(len(X_subs)):
                b, th, ct, good, its = sweep_nn_core(
                    X, X_subs[t], Ys[t], L_subs[t], lam_pads[t], valids[t],
                    beta0s[t], tol, float(gap_scales[t]), **kw)
                out.append((b, th, ct) + pad(good, its, len(valids[t])))
            return out
    axes = _SGL_SWEEP_AXES if kind == "sgl" else _NN_SWEEP_AXES
    if centered:
        axes = axes + (0,)
    if fold_shard_compatible(mesh, n_folds):
        return shard_over_folds(run, mesh, axes)
    return run_unsharded(run, mesh)


def _spectral_norms_f(X_subs: torch.Tensor) -> torch.Tensor:
    """``||A||_2^2`` of every member of a (Ka, N, p_b) stack, by 25 power
    iterations each (the reference vmaps the same)."""
    return torch.stack([spectral_norm(A, iters=25) ** 2 for A in X_subs])


# ---------------------------------------------------------------------------
# Chunk policies
# ---------------------------------------------------------------------------

def _build_rem(lambdas, j_pos, act):
    """Per-active-fold remaining grids, padded to a common pow2 length by
    repeating each fold's last lambda (extra rows are screened and
    discarded on the host slice)."""
    J = len(lambdas)
    Lp = _pow2_len(int((J - j_pos[act]).max()))
    rem = np.empty((len(act), Lp))
    for i, k in enumerate(act):
        r = lambdas[j_pos[k]:]
        rem[i, :len(r)] = r
        rem[i, len(r):] = r[-1]
    return rem


def _next_chunk_len(spec_m, accepted, limited=None, cap: int = 64):
    """Lockstep chunk policy: double the shared speculative chunk when
    every fold certified everything; otherwise throttle to the slowest
    fold's accepted prefix.  Folds whose chunk was capped by their
    remaining grid (``limited``) count in neither test; with every fold
    grid-limited the chunk doubles."""
    if limited is None:
        limited = [False] * len(accepted)
    free = [ab for ab, lim in zip(accepted, limited) if not lim]
    if all(a == b for a, b in free):
        return min(2 * spec_m, cap)
    return max(2, min(a for a, b in free if a < b))


def _next_fold_chunk(chunk: int, kk: int, mk: int, cap: int) -> int:
    """Elastic per-fold chunk policy: a fold that certified its whole chunk
    doubles ITS OWN chunk; a failed certificate throttles only that fold."""
    if kk == mk:
        return min(2 * max(chunk, 1), cap)
    return max(2, kk)


# ---------------------------------------------------------------------------
# The shared fold scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Launch:
    """One dispatched fold-batched sweep."""
    sweep: list          # [(k, fkk, mk, limited)] cohort members
    col_idxs: list       # per-member solver column indices
    lam_pads: np.ndarray  # (Ka, len2) padded lambda chunks
    outputs: list        # per member (betas, thetas, cthetas, good, iters)
    p_b: int
    g_b: int


class _FoldEngine:
    """Shared scheduler state and acceptance logic of the fold drivers.

    Subclasses provide ``_screen_call(act, rem)`` (the stacked grid screen,
    one GEMM, read back to the host) and ``make_launch(cohort)`` (bucketed
    subproblems and one sweep launch).  ``run`` owns the grid cursors, the
    chunk policies and the launch queue."""

    def __init__(self, X, masks_np, y_rows_np, lambdas, lam_max_np, xty_np,
                 *, tol, max_iter, safety, check_every, min_bucket, margin,
                 kernels, screen_mode, stats, seen_keys, mesh=None):
        self.X = X
        self.mesh = mesh
        self.dev, self.dtype = X.device, X.dtype
        self.N, self.p = X.shape
        self.masks_np = masks_np
        self.y_rows_np = y_rows_np
        self.lambdas = lambdas
        self.J = len(lambdas)
        self.K = masks_np.shape[0]
        self.lam_max_np = lam_max_np
        self.xty_np = xty_np
        self.tol = tol
        self.max_iter = max_iter
        self.safety = safety
        self.check_every = check_every
        self.min_bucket = min_bucket
        self.margin = margin
        self.kernels = kernels
        self.screen_kernels = kernels    # the screen's reductions
        self.screen_mode = screen_mode
        self.stats = stats
        self.seen_keys = seen_keys
        self.screen_time = 0.0
        self.solve_time = 0.0
        # feature sharding (the screens only: the sweeps keep full-X
        # certification); subclasses set these up given a partition
        self.fshard = None
        self.fops = None
        self.Xs = None

        K, J, p = self.K, self.J, self.p
        lam_max_safe = np.where(lam_max_np > 0, lam_max_np, 1.0)
        self.Theta = masks_np * y_rows_np / lam_max_safe[:, None]
        self.Cprev = xty_np / lam_max_safe[:, None]
        self.lam_bar = lam_max_safe.copy()
        self.Beta = np.zeros((K, p))
        self.j_pos = np.zeros(K, dtype=int)
        self.betas_out = np.zeros((K, J, p))
        self.iters_out = np.zeros((K, J), dtype=np.int64)
        self.kept_out = np.zeros((K, J), dtype=np.int64)
        self.gap_scales = np.maximum(
            0.5 * np.sum((masks_np * y_rows_np) ** 2, axis=1), 1e-30)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.dev)

    def _shard(self, fshard, fops) -> None:
        """Set up the sharded screens over the partition ``fshard`` with
        the executor ``fops``: the local blocks of X and the per-fold
        column norms, stacked."""
        self.fshard, self.fops = fshard, fops
        self.Xs = self.fops.blocks(self.fshard, self.X)
        self.col_n_sf = self.fops.scatter(self.fshard, self.col_n_f)

    def load_init(self, init: FoldState) -> None:
        """Seed the warm-start chain from an exact per-fold reference state
        (``SGLSession.refine``)."""
        self.lam_bar = np.asarray(init.lam_bar, dtype=float).copy()
        self.Theta = np.asarray(init.theta, dtype=float).copy()
        self.Cprev = np.asarray(init.c_theta, dtype=float).copy()
        self.Beta = np.asarray(init.beta, dtype=float).copy()

    # -- shared pieces -------------------------------------------------------

    def advance_zero_prefix(self, k: int, counts: np.ndarray) -> None:
        """Fully-screened prefix for fold k: beta* = 0 on those grid points
        and the exact dual optimum is y/lam, so the fold advances without
        solving."""
        adv = int(np.argmax(counts > 0)) if counts.any() else len(counts)
        lam_new = float(self.lambdas[self.j_pos[k] + adv - 1])
        self.lam_bar[k] = lam_new
        self.Theta[k] = self.masks_np[k] * self.y_rows_np[k] / lam_new
        self.Cprev[k] = self.xty_np[k] / lam_new
        self.Beta[k] = 0.0
        self.j_pos[k] += adv

    def screen(self, act: np.ndarray) -> np.ndarray:
        """One stacked grid screen over the ready folds' remaining grids:
        a single ``(K*L, N) x (N, p)`` GEMM inside ``_screen_call``."""
        rem = _build_rem(self.lambdas, self.j_pos, act)
        if self.screen_mode == "none":
            return np.ones((len(act), rem.shape[1], self.p), dtype=bool)
        ts = time.perf_counter()
        fk_np = self._screen_call(act, rem)                 # one host read
        self.stats.n_screens += 1                           # ONE GEMM issued
        self.stats.n_pallas_screens += int(self.screen_kernels)
        self.screen_time += time.perf_counter() - ts
        return fk_np

    def harvest(self, launch: _Launch):
        """Accept each fold's certified prefix and carry its exact dual
        forward.  Row 0 of every fold is solved on a provably safe superset,
        so ``kk >= 1`` guarantees progress."""
        ts = time.perf_counter()
        accepted = []
        for t, (k, _, mk, limited) in enumerate(launch.sweep):
            betas_b, thetas_b, cthetas_b, good_b, iters_b = launch.outputs[t]
            good = good_b[:mk]
            kk = int(np.argmin(good)) if not good.all() else mk
            if kk == 0:
                kk = 1
            self.stats.n_rejected += int(mk - kk)
            self.stats.fista_iters += int(iters_b.sum())
            col_idx = launch.col_idxs[t]
            rows = np.zeros((kk, self.p))
            rows[:, col_idx] = torch.stack(betas_b[:kk])[:, :len(col_idx)] \
                .cpu().numpy()
            j0 = self.j_pos[k]
            self.betas_out[k, j0:j0 + kk] = rows
            self.iters_out[k, j0:j0 + kk] = iters_b[:kk]
            self.kept_out[k, j0:j0 + kk] = len(col_idx)
            self.Beta[k] = rows[-1]
            self.Theta[k] = thetas_b[kk - 1].cpu().numpy()
            self.Cprev[k] = cthetas_b[kk - 1].cpu().numpy()
            self.lam_bar[k] = float(launch.lam_pads[t, kk - 1])
            self.j_pos[k] += kk
            accepted.append((k, kk, mk, limited))
        self.solve_time += time.perf_counter() - ts
        self.stats.buckets.append(
            (launch.p_b, launch.g_b, max(mk for _, _, mk, _ in launch.sweep),
             min(kk for _, kk, _, _ in accepted)))
        return accepted

    @staticmethod
    def _pick_launch(inflight: list) -> _Launch:
        """The oldest launch: a launch of this port has finished when
        ``make_launch`` returns, so none is more ready than another."""
        return inflight.pop(0)

    def _launch_args(self, cohort):
        """The launch's chunk length ``len2`` and its members' padded
        lambda chunks and valid-row flags."""
        Ka = len(cohort)
        len2 = _pow2_len(max(mk for _, _, mk, _ in cohort))
        lam_pads = np.zeros((Ka, len2))
        valids = np.zeros((Ka, len2), dtype=bool)
        for t, (k, _, mk, _) in enumerate(cohort):
            chunk = self.lambdas[self.j_pos[k]:self.j_pos[k] + mk]
            lam_pads[t, :mk] = chunk
            lam_pads[t, mk:] = chunk[-1]
            valids[t, :mk] = True
        return len2, lam_pads, valids

    def _sub_designs(self, cohort, col_idxs, p_b, mus64=None):
        """(Ka, N, p_b) stack of the members' masked (and, with ``mus64``,
        centered) solver designs, built on the device from the shared X.
        Centering is taken in float64 and rounded once, as the reference's
        host-built stack is."""
        X_subs = torch.zeros((len(cohort), self.N, p_b), dtype=self.dtype,
                             device=self.dev)
        for t, ((k, _, _, _), col_idx) in enumerate(zip(cohort, col_idxs)):
            idx = self._dev(col_idx, torch.int64)
            cols = torch.index_select(self.X, 1, idx)
            mask = self.masks_d[k][:, None]
            if mus64 is not None:
                cols = ((cols.to(torch.float64) - mus64[k][idx][None, :])
                        * mask.to(torch.float64))
            else:
                cols = cols * mask
            X_subs[t, :, :len(col_idx)] = cols.to(self.dtype)
        return X_subs

    # -- the scheduler loop --------------------------------------------------

    def run(self, schedule: str, chunk_init: int, chunk_cap: int) -> None:
        """Drive every fold through the grid.

        Lockstep: one cohort per step containing every ready fold, one
        shared chunk length (``_next_chunk_len``), launch then harvest.
        Elastic: per-fold chunk lengths (``_next_fold_chunk``), ready folds
        grouped into cohorts of like chunk length, each cohort its own
        launch; a fold is screened and launched again as soon as ITS launch
        is harvested."""
        K, J = self.K, self.J
        j_pos = self.j_pos
        spec_m = max(int(chunk_init), 1)              # lockstep shared chunk
        chunk = np.full(K, max(int(chunk_init), 1), dtype=int)
        busy = np.zeros(K, dtype=bool)
        inflight: list = []
        fold_sweeps = np.zeros(K, dtype=np.int64)

        def pace(k):
            return _pow2_len(int(chunk[k]))

        while (j_pos < J).any() or inflight:
            ready = np.nonzero((j_pos < J) & ~busy)[0]
            if schedule == "elastic" and len(ready) and busy.any():
                # pace hysteresis: a ready fold whose chunk is within 2x of
                # an in-flight fold's waits one harvest so the two re-merge
                # into a single launch
                busy_cls = {pace(b) for b in np.nonzero(busy)[0]}
                ready = np.asarray(
                    [k for k in ready
                     if not any(c // 2 <= pace(k) <= 2 * c
                                for c in busy_cls)], dtype=int)
            sweep = []
            if len(ready):
                fk_np = self.screen(ready)            # ONE stacked GEMM
                for i, k in enumerate(ready):
                    fkk = fk_np[i][:J - j_pos[k]]
                    counts = fkk.sum(axis=1)
                    if counts[0] == 0:
                        self.advance_zero_prefix(k, counts)
                        continue
                    budget = spec_m if schedule == "lockstep" else \
                        int(chunk[k])
                    mk = min(J - j_pos[k], budget)
                    sweep.append((k, fkk, mk, mk < budget))
            if sweep:
                if schedule == "lockstep":
                    cohorts = [sweep]
                else:
                    # cohorts band folds within a 2x chunk ratio: a
                    # cohort's folds share the launch's chunk length
                    entries = sorted(sweep, key=lambda e: -pace(e[0]))
                    cohorts = []
                    for e in entries:
                        if cohorts and 2 * pace(e[0]) >= \
                                pace(cohorts[-1][0][0]):
                            cohorts[-1].append(e)
                        else:
                            cohorts.append([e])
                for cohort in cohorts:
                    inflight.append(self.make_launch(cohort))
                    self.stats.n_segments += 1
                    for k, _, _, _ in cohort:
                        busy[k] = True
                        fold_sweeps[k] += 1
            if inflight:
                launch = self._pick_launch(inflight)
                accepted = self.harvest(launch)
                limited_flags = [lim for _, _, _, lim in accepted]
                for k, kk, mk, _ in accepted:
                    busy[k] = False
                    if schedule == "elastic":
                        chunk[k] = _next_fold_chunk(int(chunk[k]), kk, mk,
                                                    chunk_cap)
                if schedule == "lockstep":
                    spec_m = _next_chunk_len(
                        spec_m, [(kk, mk) for _, kk, mk, _ in accepted],
                        limited_flags, cap=chunk_cap)
        self.stats.fold_sweeps = fold_sweeps


class _SGLFoldEngine(_FoldEngine):
    """SGL screening (TLFre) and group-bucketed sweeps."""

    def __init__(self, *args, spec, alpha, Y, masks_d, col_n_f, gspec_f,
                 lam_max_f, n_bound, mus_d, mus64, graphs,
                 min_group_bucket: int = 16, fshard=None, fops=None,
                 loss=SQUARED, **kw):
        super().__init__(*args, **kw)
        self.graphs = graphs
        self.spec = spec
        self.alpha = alpha
        self.loss = loss
        self.Y = Y
        self.masks_d = masks_d
        self.col_n_f = col_n_f
        self.gspec_f = gspec_f
        self.lam_max_f = lam_max_f
        self.n_bound = n_bound
        self.mus_d = mus_d
        self.mus64 = mus64
        self.centered = mus_d is not None
        self.G = spec.num_groups
        self.gid = spec.group_ids.cpu().numpy()
        self.sizes_np = spec.sizes.cpu().numpy()
        self.weights_np = spec.weights.cpu().numpy()
        self.fw_np = (None if spec.feature_weights is None
                      else spec.feature_weights.cpu().numpy())
        # the fused group statistics take one l1 threshold
        self.screen_kernels = self.kernels and self.fw_np is None
        self.min_group_bucket = min_group_bucket
        if fshard is not None:
            self._shard(fshard, fops)
            self.specs_s = self.fops.local(self.fshard.specs)
            self.gspec_sf = self.fops.scatter_groups(self.fshard, gspec_f)
            self.mus_sf = (self.fops.scatter(self.fshard, mus_d)
                           if self.centered else None)

    def _screen_call(self, act: np.ndarray, rem: np.ndarray) -> np.ndarray:
        a_idx = self._dev(act, torch.int64)
        if self.fshard is not None:
            fk_s = _screen_folds_sgl_feat(
                self.fops, self.Xs, self.Y[a_idx], self.spec, self.specs_s,
                self.alpha, self._dev(rem), self._dev(self.lam_bar[act]),
                self.lam_max_f[a_idx], self._dev(self.Theta[act]),
                self.n_bound[a_idx], self._dev(self.Beta[act]),
                self.fops.scatter(self.fshard, self._dev(self.Beta[act])),
                self.fops.scatter(self.fshard, self._dev(self.Cprev[act])),
                self.masks_d[a_idx], self.col_n_sf[:, a_idx],
                self.gspec_sf[:, a_idx], self.safety,
                self.mus_sf[:, a_idx] if self.centered else None,
                screen=self.screen_mode, use_kernels=self.screen_kernels)
            return self.fshard.unshard_features(self.fops.gather(fk_s))
        return _screen_folds_sgl(
            self.X, self.Y[a_idx], self.spec, self.alpha, self._dev(rem),
            self._dev(self.lam_bar[act]), self.lam_max_f[a_idx],
            self._dev(self.Theta[act]), self.n_bound[a_idx],
            self._dev(self.Beta[act]), self._dev(self.Cprev[act]),
            self.masks_d[a_idx],
            self.col_n_f[a_idx], self.gspec_f[a_idx], self.safety,
            self.mus_d[a_idx] if self.centered else None,
            screen=self.screen_mode,
            use_kernels=self.screen_kernels).cpu().numpy()

    def make_launch(self, cohort) -> _Launch:
        ts = time.perf_counter()
        N, p, G = self.N, self.p, self.G
        p_b = max(_feature_bucket(int(fkk[0].sum()), p, self.min_bucket,
                                  self.margin)
                  for _, fkk, _, _ in cohort)
        S_list = [_expand_set(fkk[0], fkk, p_b) for _, fkk, _, _ in cohort]
        g_b = min(max(_bucket(len(np.unique(self.gid[S])) + 2,
                              self.min_group_bucket) for S in S_list), G + 1)
        for (k, _, _, _), S in zip(cohort, S_list):
            # same margin rule as the single-fold engine, per-fold c_prev
            margin_fill_sgl(S, self.Cprev[k], self.gid, self.sizes_np,
                            self.weights_np, p_b, g_b, self.fw_np)

        Ka = len(cohort)
        len2, lam_pads, valids = self._launch_args(cohort)
        sub_specs, col_idxs = [], []
        for S in S_list:
            sub_spec, col_idx = self.spec.bucketed_subset(S, p_b, g_b)
            sub_specs.append(sub_spec)
            col_idxs.append(col_idx)
        X_subs = self._sub_designs(cohort, col_idxs, p_b, self.mus64)
        beta0s = np.zeros((Ka, p_b))
        for t, ((k, _, _, _), col_idx) in enumerate(zip(cohort, col_idxs)):
            beta0s[t, :len(col_idx)] = self.Beta[k][col_idx]
        L_subs = _spectral_norms_f(X_subs)
        # the reference's compile key: every dim its jit cache
        # discriminates on, so n_compilations counts the same shapes
        key = ("sgl-folds", Ka, N, p, G, str(self.dtype), self.max_iter,
               self.check_every, self.mesh, p_b, g_b, self.spec.max_size,
               len2, self.centered, self.kernels, self.loss.name)
        if key not in self.seen_keys:
            self.seen_keys.add(key)
            self.stats.n_compilations += 1
        ks = [k for k, _, _, _ in cohort]
        k_rows = self._dev(ks, torch.int64)
        runner = _fold_sweep("sgl", self.mesh, Ka, self.max_iter,
                             self.check_every, self.kernels, loss=self.loss,
                             graphs=self.graphs, centered=self.centered)
        args = [self.X, X_subs, self.Y[k_rows], self.spec, sub_specs,
                self.alpha, L_subs, self._dev(lam_pads), valids,
                self._dev(beta0s), self.tol, self.gap_scales[ks]]
        if self.centered:
            args.append(self.mus_d[k_rows])
        outputs = runner(*args)
        self.solve_time += time.perf_counter() - ts
        return _Launch(sweep=cohort, col_idxs=col_idxs, lam_pads=lam_pads,
                       outputs=outputs, p_b=p_b, g_b=g_b)


class _NNFoldEngine(_FoldEngine):
    """Nonnegative-Lasso screening (DPC) and flat-bucket sweeps."""

    def __init__(self, *args, Y, masks_d, col_n_f, lam_max_f, n_bound,
                 fshard=None, fops=None, **kw):
        super().__init__(*args, **kw)
        self.Y = Y
        self.masks_d = masks_d
        self.col_n_f = col_n_f
        self.lam_max_f = lam_max_f
        self.n_bound = n_bound
        if fshard is not None:
            self._shard(fshard, fops)

    def _screen_call(self, act: np.ndarray, rem: np.ndarray) -> np.ndarray:
        a_idx = self._dev(act, torch.int64)
        if self.fshard is not None:
            fk_s = _screen_folds_nn_feat(
                self.fops, self.Xs, self.Y[a_idx], self._dev(rem),
                self._dev(self.lam_bar[act]), self.lam_max_f[a_idx],
                self._dev(self.Theta[act]), self.n_bound[a_idx],
                self._dev(self.Beta[act]),
                self.fops.scatter(self.fshard, self._dev(self.Beta[act])),
                self.fops.scatter(self.fshard, self._dev(self.Cprev[act])),
                self.masks_d[a_idx], self.col_n_sf[:, a_idx], self.safety,
                screen=self.screen_mode, use_kernels=self.kernels)
            return self.fshard.unshard_features(self.fops.gather(fk_s))
        return _screen_folds_nn(
            self.X, self.Y[a_idx], self._dev(rem),
            self._dev(self.lam_bar[act]), self.lam_max_f[a_idx],
            self._dev(self.Theta[act]), self.n_bound[a_idx],
            self._dev(self.Beta[act]), self._dev(self.Cprev[act]),
            self.masks_d[a_idx], self.col_n_f[a_idx], self.safety,
            screen=self.screen_mode,
            use_kernels=self.kernels).cpu().numpy()

    def make_launch(self, cohort) -> _Launch:
        ts = time.perf_counter()
        N, p = self.N, self.p
        p_b = max(_feature_bucket(int(fkk[0].sum()), p, self.min_bucket,
                                  self.margin)
                  for _, fkk, _, _ in cohort)
        S_list = [_expand_set(fkk[0], fkk, p_b) for _, fkk, _, _ in cohort]
        for (k, _, _, _), S in zip(cohort, S_list):
            margin_fill_nn(S, self.Cprev[k], p_b)

        Ka = len(cohort)
        len2, lam_pads, valids = self._launch_args(cohort)
        col_idxs = [np.nonzero(S)[0] for S in S_list]
        X_subs = self._sub_designs(cohort, col_idxs, p_b)
        beta0s = np.zeros((Ka, p_b))
        for t, ((k, _, _, _), col_idx) in enumerate(zip(cohort, col_idxs)):
            beta0s[t, :len(col_idx)] = self.Beta[k][col_idx]
        L_subs = _spectral_norms_f(X_subs)
        key = ("nn-folds", Ka, N, p, str(self.dtype), self.max_iter,
               self.check_every, self.mesh, p_b, len2, self.kernels,
               "squared")
        if key not in self.seen_keys:
            self.seen_keys.add(key)
            self.stats.n_compilations += 1
        ks = [k for k, _, _, _ in cohort]
        runner = _fold_sweep("nn", self.mesh, Ka, self.max_iter,
                             self.check_every, self.kernels, graphs=None)
        outputs = runner(
            self.X, X_subs, self.Y[self._dev(ks, torch.int64)], L_subs,
            self._dev(lam_pads), valids, self._dev(beta0s), self.tol,
            self.gap_scales[ks])
        self.solve_time += time.perf_counter() - ts
        return _Launch(sweep=cohort, col_idxs=col_idxs, lam_pads=lam_pads,
                       outputs=outputs, p_b=p_b, g_b=0)


# ---------------------------------------------------------------------------
# Fold-batched paths
# ---------------------------------------------------------------------------

def _fold_inputs(X, y, masks, lambdas, schedule, use_kernels):
    """Shared argument handling of the fold drivers."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                         f"{SCHEDULES}")
    if use_kernels and X.dtype == torch.float64:
        _require_f32_for_pallas(X.dtype)
    _refuse_tf32(X)
    N = X.shape[0]
    masks_np = _host(masks)
    K = masks_np.shape[0]
    y_rows_np = _host(y)
    if y_rows_np.ndim == 1:
        y_rows_np = np.broadcast_to(y_rows_np, (K, N))
    lambdas = _host(lambdas)
    kernels = _kernels_active(use_kernels, X.dtype, X.device)
    masks_d = torch.as_tensor(masks_np, dtype=X.dtype, device=X.device)
    Y = masks_d * torch.as_tensor(np.array(y_rows_np), dtype=X.dtype,
                                  device=X.device)
    return masks_np, y_rows_np, lambdas, kernels, masks_d, Y


def sgl_fold_paths(X, y, spec: GroupSpec, alpha, masks, lambdas, *,
                   screen: str = "tlfre", tol=1e-9, max_iter: int = 20000,
                   safety: float = 0.0, specnorm_method: str = "power",
                   check_every: int = 10, min_bucket: int = 64,
                   min_group_bucket: int = 16, margin: float = 0.125,
                   chunk_init: int = 8, chunk_cap: int = 64,
                   schedule: str = "elastic", use_kernels=None, mesh=None,
                   mus=None, init=None, compile_keys=None,
                   fista_graphs=None, feature_shards: int = 0, loss=SQUARED):
    """Solve the SAME lambda grid on K masked row subsets of (X, y).

    ``X`` is a device tensor, ``spec`` on its device.  ``masks``: (K, N)
    0/1, 1 marking subset k's training rows.  ``y`` is (N,), shared by
    every subset, or (K, N) per-fold responses on the full row index.
    ``mus`` (optional, (K, p)): per-fold train-row column means for
    leakage-free centering; fold k then solves on ``M_k (X - 1 mu_k^T)``
    through rank-one corrections of the shared-X algebra, and the caller
    supplies ``y`` rows centered by the per-fold means.  ``init`` (a
    ``FoldState``) seeds each fold's warm-start chain at its ``lam_bar``
    instead of its own lambda_max.  ``use_kernels``, ``compile_keys`` and
    ``fista_graphs`` as in ``sgl_path_batched``.
    Returns ``(betas (K, J, p), kept (K, J), iters (K, J), stats,
    (screen_time, solve_time, setup_time))``; grid points at or above a
    fold's own lambda_max get exact zeros.

    ``loss`` must support the masked-row embedding (``f(0, 0) == 0`` per
    sample); the logistic loss does not and raises
    ``NotImplementedError``.  With adaptive feature weights the screen's
    fold-stack statistics and the fused prox (one l1 threshold each) run
    plainly; ``xtv`` still certifies every row.  ``feature_shards > 1``
    shards the stacked grid screens (see the module docstring); adaptive
    feature weights refuse it with ``ValueError``."""
    if screen not in ("tlfre", "gapsafe", "none"):
        raise ValueError(f"unknown screen mode {screen!r}")
    loss = get_loss(loss)
    if not loss.supports_masked_rows:
        # the masked-row embedding needs f(0, 0) == 0 per sample so held-out
        # rows drop out of every inner product; the logistic NLL has
        # f(0, 0) = log 2, so fold batching would corrupt every certificate
        raise NotImplementedError(
            f"fold-batched paths require a loss whose masked rows vanish; "
            f"{loss.name!r} does not support the masked-row embedding")
    if int(feature_shards) > 1 and spec.feature_weights is not None:
        raise ValueError("feature_shards does not support adaptive feature "
                         "weights; drop one or the other")
    masks_np, y_rows_np, lambdas, kernels, masks_d, Y = _fold_inputs(
        X, y, masks, lambdas, schedule, use_kernels)
    dev, dtype = X.device, X.dtype
    N, p = X.shape
    K = masks_np.shape[0]
    J = len(lambdas)
    centered = mus is not None

    # ---- per-fold geometry, batched into a handful of GEMMs ---------------
    t0 = time.perf_counter()
    col2_f = masks_d @ (X * X)                                # (K, p)
    if centered:
        mus64 = torch.as_tensor(_host(mus), dtype=torch.float64, device=dev)
        mus_d = mus64.to(dtype)
        # (X - 1 mu^T)^T v = X^T v - mu (1^T v);  sum m (x-mu)^2 = col2 - n mu^2
        xty_f = Y @ X - torch.sum(Y, dim=1)[:, None] * mus_d
        n_train = torch.sum(masks_d, dim=1)
        col2_f = torch.clamp(col2_f - n_train[:, None] * mus_d ** 2, min=0.0)
    else:
        mus64 = mus_d = None
        xty_f = Y @ X                                         # (K, p)
    lm = [lambda_max_sgl(spec, xty_f[k], alpha) for k in range(K)]
    lam_max_f = torch.stack([a for a, _ in lm])
    g_star_f = torch.stack([b for _, b in lm])
    col_n_f = torch.sqrt(col2_f)
    if specnorm_method == "power":
        # one fold at a time: peak memory stays (N, p), not (K, N, p)
        gspec_f = torch.stack([
            group_spectral_norms(
                masks_d[k][:, None] * (X - mus_d[k][None, :] if centered
                                       else X), spec)
            for k in range(K)])
    else:
        gspec_f = torch.sqrt(group_sum(spec, col2_f))
    # boundary normal of Theorem 12 at each fold's own lambda_max, masked
    lam_max_np = lam_max_f.cpu().numpy().astype(float)
    lam_max_div = torch.as_tensor(np.where(lam_max_np > 0, lam_max_np, 1.0),
                                  dtype=dtype, device=dev)
    W = shrink(xty_f / lam_max_div[:, None])
    w_star = torch.where(spec.group_ids[None, :] == g_star_f[:, None], W, 0.0)
    n_bound = w_star @ X.T                                    # (K, N)
    if centered:
        n_bound = n_bound - torch.sum(w_star * mus_d, dim=1)[:, None]
    n_bound = masks_d * n_bound
    fshard, fops = _feature_plan(feature_shards, p, spec, mesh)
    _sync(dev)
    setup_time = time.perf_counter() - t0

    stats = EngineStats()
    seen_keys = compile_keys if compile_keys is not None else set()
    eng = _SGLFoldEngine(
        X, masks_np, y_rows_np, lambdas, lam_max_np,
        xty_f.cpu().numpy().astype(float),
        tol=tol, max_iter=max_iter, safety=safety, check_every=check_every,
        min_bucket=min_bucket, margin=margin, kernels=kernels,
        screen_mode=screen, stats=stats, seen_keys=seen_keys, mesh=mesh,
        spec=spec, alpha=alpha, Y=Y, masks_d=masks_d, col_n_f=col_n_f,
        gspec_f=gspec_f, lam_max_f=lam_max_f, n_bound=n_bound, mus_d=mus_d,
        mus64=mus64, min_group_bucket=min_group_bucket, fshard=fshard,
        fops=fops, loss=loss,
        graphs=fista_graphs if fista_graphs is not None else {})
    if init is not None:
        eng.load_init(init)
    for k in range(K):
        while (eng.j_pos[k] < J
               and lambdas[eng.j_pos[k]] >= lam_max_np[k] * (1.0 - 1e-12)):
            eng.j_pos[k] += 1                # beta* = 0 at/above fold lam_max
    eng.run(schedule, chunk_init, chunk_cap)

    return eng.betas_out, eng.kept_out, eng.iters_out, stats, (
        eng.screen_time, eng.solve_time, setup_time)


def nn_fold_paths(X, y, masks, lambdas, *, screen: str = "dpc", tol=1e-9,
                  max_iter: int = 20000, safety: float = 0.0,
                  check_every: int = 10, min_bucket: int = 64,
                  margin: float = 0.125, chunk_init: int = 8,
                  chunk_cap: int = 64, schedule: str = "elastic",
                  use_kernels=None, mesh=None, init=None, compile_keys=None,
                  feature_shards: int = 0):
    """Nonnegative-Lasso analogue of ``sgl_fold_paths`` (DPC screens, no
    centering; ``init`` and ``feature_shards`` as there, the partition
    singleton-column).  A fold whose ``max_i <x_i, y>`` is nonpositive has
    the all-zero path and drops out."""
    if screen not in ("dpc", "gapsafe", "none"):
        raise ValueError(f"unknown screen mode {screen!r}")
    masks_np, y_rows_np, lambdas, kernels, masks_d, Y = _fold_inputs(
        X, y, masks, lambdas, schedule, use_kernels)
    dev = X.device
    K = masks_np.shape[0]
    J = len(lambdas)

    t0 = time.perf_counter()
    xty_f = Y @ X
    lam_max_f = torch.amax(xty_f, dim=1)
    i_star_f = torch.argmax(xty_f, dim=1)
    col_n_f = torch.sqrt(masks_d @ (X * X))
    lam_max_np = lam_max_f.cpu().numpy().astype(float)
    n_bound = masks_d * X[:, i_star_f].T                      # (K, N)
    fshard, fops = _feature_plan(feature_shards, X.shape[1], None, mesh)
    _sync(dev)
    setup_time = time.perf_counter() - t0

    stats = EngineStats()
    seen_keys = compile_keys if compile_keys is not None else set()
    eng = _NNFoldEngine(
        X, masks_np, y_rows_np, lambdas, lam_max_np,
        xty_f.cpu().numpy().astype(float),
        tol=tol, max_iter=max_iter, safety=safety, check_every=check_every,
        min_bucket=min_bucket, margin=margin, kernels=kernels,
        screen_mode=screen, stats=stats, seen_keys=seen_keys, mesh=mesh,
        Y=Y, masks_d=masks_d, col_n_f=col_n_f, lam_max_f=lam_max_f,
        n_bound=n_bound, fshard=fshard, fops=fops)
    if init is not None:
        eng.load_init(init)
    for k in range(K):
        if lam_max_np[k] <= 0:
            eng.j_pos[k] = J                   # all-zero path for this fold
            continue
        while (eng.j_pos[k] < J
               and lambdas[eng.j_pos[k]] >= lam_max_np[k] * (1.0 - 1e-12)):
            eng.j_pos[k] += 1
    eng.run(schedule, chunk_init, chunk_cap)

    return eng.betas_out, eng.kept_out, eng.iters_out, stats, (
        eng.screen_time, eng.solve_time, setup_time)


# ---------------------------------------------------------------------------
# K-fold cross-validation statistics
# ---------------------------------------------------------------------------

def _cv_statistics(X_np, y_np, folds, lambdas, betas, lam_max, kept, stats,
                   times, iters=None, mus=None, y_means=None):
    """Held-out MSE / selection statistics from per-fold grid solutions.

    With per-fold centering (``mus`` / ``y_means``) fold k's betas solve the
    centered training problem, so its held-out prediction is
    ``X beta - mu_k . beta + ybar_k``."""
    K = len(folds)
    J = len(lambdas)
    mse = np.zeros((K, J))
    for k, (_, val) in enumerate(folds):
        pred = betas[k] @ X_np[val].T                            # (J, |val|)
        if mus is not None:
            pred = pred - (betas[k] @ mus[k])[:, None] + y_means[k]
        err = y_np[val][None, :] - pred
        mse[k] = np.mean(err * err, axis=1)
    mean_mse = mse.mean(axis=0)
    se_mse = mse.std(axis=0, ddof=1) / np.sqrt(K) if K > 1 else \
        np.zeros(J)
    best = int(np.argmin(mean_mse))
    # 1-SE rule: sparsest (largest-lambda) model within one SE of the best
    within = np.nonzero(mean_mse <= mean_mse[best] + se_mse[best])[0]
    idx_1se = int(within[np.argmax(lambdas[within])])
    return CVResult(
        lambdas=lambdas, fold_betas=betas, mse_path=mse, mean_mse=mean_mse,
        se_mse=se_mse, best_index=best, best_lambda=float(lambdas[best]),
        index_1se=idx_1se, lambda_1se=float(lambdas[idx_1se]), folds=folds,
        lam_max=lam_max, kept_features=kept, stats=stats,
        screen_time=times[0], solve_time=times[1], setup_time=times[2],
        fold_iters=iters)


# ---------------------------------------------------------------------------
# Legacy entry points: thin shims over SGLSession.cv and .stability
# ---------------------------------------------------------------------------

def sgl_cv(X, y, spec, alpha, *, n_folds: int = 5, folds=None, lambdas=None,
           n_lambdas: int = 100, min_ratio: float = 0.01,
           screen: str = "tlfre", tol=1e-9, max_iter: int = 20000,
           safety: float = 0.0, specnorm_method: str = "power",
           check_every: int = 10, seed: int = 0, mesh=None,
           min_bucket: int = 64, min_group_bucket: int = 16,
           margin: float = 0.125, chunk_init: int = 8,
           center: str = "global", device=None, dtype=None) -> CVResult:
    """K-fold cross-validation for SGL over a shared lambda grid: a legacy
    entry point, kept as a thin shim that builds a one-shot
    ``Problem``/``Plan`` and runs ``SGLSession.cv`` (a persistent session
    also reuses compiled buckets).  ``device`` and ``dtype`` as in
    ``Problem.sgl``: ``device=None`` means the card."""
    from .problem import Plan, Problem, warn_legacy_entry_point
    from .session import SGLSession
    warn_legacy_entry_point("sgl_cv", "SGLSession.cv")
    plan = Plan(alpha=alpha, lambdas=lambdas, n_lambdas=n_lambdas,
                min_ratio=min_ratio, screen=screen, tol=tol,
                max_iter=max_iter, safety=safety,
                specnorm_method=specnorm_method, check_every=check_every,
                min_bucket=min_bucket, min_group_bucket=min_group_bucket,
                margin=margin, chunk_init=chunk_init, n_folds=n_folds,
                folds=folds, seed=seed, center=center, mesh=mesh)
    return SGLSession(Problem.sgl(X, y, spec, dtype=dtype,
                                  device=device)).cv(plan)


def nn_lasso_cv(X, y, *, n_folds: int = 5, folds=None, lambdas=None,
                n_lambdas: int = 100, min_ratio: float = 0.01,
                screen: str = "dpc", tol=1e-9, max_iter: int = 20000,
                safety: float = 0.0, check_every: int = 10, seed: int = 0,
                mesh=None, min_bucket: int = 64, margin: float = 0.125,
                chunk_init: int = 8, device=None, dtype=None) -> CVResult:
    """K-fold cross-validation for the nonnegative Lasso (DPC screening):
    the legacy shim over ``SGLSession.cv`` (see ``sgl_cv``)."""
    from .problem import Plan, Problem, warn_legacy_entry_point
    from .session import SGLSession
    warn_legacy_entry_point("nn_lasso_cv", "SGLSession.cv")
    plan = Plan(lambdas=lambdas, n_lambdas=n_lambdas, min_ratio=min_ratio,
                screen=screen, tol=tol, max_iter=max_iter, safety=safety,
                check_every=check_every, min_bucket=min_bucket,
                margin=margin, chunk_init=chunk_init, n_folds=n_folds,
                folds=folds, seed=seed, mesh=mesh)
    return SGLSession(Problem.nn_lasso(X, y, dtype=dtype,
                                       device=device)).cv(plan)


def stability_selection(X, y, spec, alpha, *, n_subsamples: int = 50,
                        frac: float = 0.5, lambdas=None, n_lambdas: int = 30,
                        min_ratio: float = 0.05, active_tol: float = 1e-8,
                        screen: str = "tlfre", tol=1e-7,
                        max_iter: int = 20000, safety: float = 0.0,
                        check_every: int = 10, seed: int = 0, mesh=None,
                        batch_size: int = 10, specnorm_method: str = "fro",
                        device=None, dtype=None) -> StabilityResult:
    """Selection probabilities over random row subsamples, fold-batched: the
    legacy shim over ``SGLSession.stability``.  Runs the SGL grid on
    ``n_subsamples`` random ``frac``-subsamples (``batch_size`` at a time
    through the fold engine) and reports the fraction of subsamples in
    which each feature is active at each lambda.  ``specnorm_method``
    defaults to the Frobenius bound: the per-subsample power iterations are
    the only setup cost that grows with the batch, and the bound only
    loosens the screen.  ``device`` and ``dtype`` as in ``sgl_cv``."""
    from .problem import Plan, Problem, warn_legacy_entry_point
    from .session import SGLSession
    warn_legacy_entry_point("stability_selection", "SGLSession.stability")
    plan = Plan(alpha=alpha, lambdas=lambdas, n_lambdas=n_lambdas,
                min_ratio=min_ratio, screen=screen, tol=tol,
                max_iter=max_iter, safety=safety,
                specnorm_method=specnorm_method, check_every=check_every,
                seed=seed, mesh=mesh, n_subsamples=n_subsamples,
                subsample_frac=frac, active_tol=active_tol,
                batch_size=batch_size)
    return SGLSession(Problem.sgl(X, y, spec, dtype=dtype,
                                  device=device)).stability(plan)
