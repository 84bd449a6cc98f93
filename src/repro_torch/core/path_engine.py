"""Batched lambda-path engine: SGL with TLFre screening and the
nonnegative Lasso with DPC screening (PyTorch port of
``repro.core.path_engine.sgl_path_batched`` / ``nn_lasso_path_batched``,
single device).

Each segment of the path does three things:

  1. **Grid screening.**  The whole remaining lambda grid is screened in one
     shot: the Theorem-12 ball centers share ``theta_bar``, so the L
     screening GEMVs collapse into one (L, N) x (N, p) GEMM; the group
     statistics go through the ``screen_norms`` kernel.  Row 0 of the grid
     (the next lambda) is the segment's safe base set.  ``screen='gapsafe'``
     intersects it with the Gap-Safe ball around the latest certified dual
     (a GEMV-sized step: the center is fixed across the grid, only the
     radii vary); a non-squared loss screens with that ball alone.

  2. **Speculative bucketed sweep with certification.**  The next ``m``
     lambdas are solved on one feature set S = safe base set + nearby-row
     union + a margin of top-ranked groups, padded to a power-of-two bucket
     (``GroupSpec.bucketed_subset``), warm-started row to row.  FISTA runs
     the fused ``sgl_prox`` kernel every iteration.  Each solved row then
     certifies itself against the FULL problem: one full-X GEMV (the ``xtv``
     kernel) recovers the exact dual (Lemma-9 scaling) and the duality gap.
     The sweep stops at the first failed certificate.

  3. **Host bookkeeping.**  The certified prefix is accepted and the next
     segment screens against the last accepted row's exact dual.

The reference runs step 2 as one jitted ``lax.scan``/``lax.cond``; here it
is a Python loop over device tensors that reads the FISTA gap on the host
every ``check_every`` iterations and each row's certificate once.  On the
card's float32 kernel route each block of ``check_every`` iterations is a
replay of a captured CUDA graph (``solver.fista_sgl_graphed``).  Sweep
shapes are counted with the reference's compile keys, so
``EngineStats.n_compilations`` reports the same numbers (a warm second call
reports 0).  The kernels run for float32 on CUDA (``_kernels_active``) and
never for float64.  Each kernel is gated on the function it computes:
``xtv`` certifies every row whatever the loss or weights; ``sgl_prox``
and the ``screen_norms`` group statistics take one l1 threshold, so they
run whenever the spec carries no adaptive feature weights, whatever the
loss.  The nonnegative-Lasso path has the same three steps with the DPC
grid rule (Theorem 22) and the prox ``(v - t*lam)_+``; its only kernel is
the ``xtv`` certification GEMV.

``feature_shards > 1`` runs the screening GEMMs, the group statistics and
the certification feature-parallel over a group-aligned column partition
(``distributed.feature_shard``): across the ranks of a ``torch.distributed``
group of that size, else stacked on one device.  Kept sets and accepted
betas match the unsharded engine's: every cross-shard reduction (the min of
the shrink roots, the max of the correlations) is exactly associative.
The solve bucket stays on one device.  The kernels run on each block as
they do on the full design: ``xtv`` certifies every row once a block,
``screen_norms`` takes each block's screen.  The reference turns every
kernel off on this route, so its float32 ``n_pallas_screens`` is 0 where
this port counts every screen.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .dpc import (dpc_screen_grid, dpc_screen_grid_feat, dual_scaling_nn,
                  gap_safe_screen_grid_nn, gap_safe_screen_grid_nn_feat,
                  lambda_max_nn, normal_vector_nn)
from .estimation import normal_vector_sgl
from .fenchel import sgl_penalty, shrink
from .groups import GroupSpec
from .lambda_max import dual_scaling_sgl, lambda_max_sgl
from .linalg import (column_norms, group_frobenius_norms,
                     group_spectral_norms, spectral_norm)
from .losses import SQUARED, get_loss
from .path import PathResult, _bucket, default_lambda_grid
from .screening import (_require_f32_for_pallas, _xtv, gap_safe_grid_radii,
                        gap_safe_grid_radii_loss, gap_safe_screen_grid,
                        gap_safe_screen_grid_feat, tlfre_screen_grid,
                        tlfre_screen_grid_feat)
from .solver import fista_nn_lasso, fista_sgl, fista_sgl_graphed


@dataclasses.dataclass
class EngineStats:
    """Host-interaction accounting for the batched engine.

    ``n_segments`` counts sweep round-trips, ``n_compilations`` distinct
    sweep shapes (the reference's jit compilations), ``n_rejected``
    speculative rows whose certificate failed, ``n_pallas_screens`` grid
    screens whose group statistics ran through the fused kernels (always
    0 on float64 paths and under feature weights; on a float32 logistic
    path, unlike the reference's, every screen), ``fista_iters`` the FISTA iterations run (rejected rows'
    included).  ``fold_sweeps`` (fold drivers only) counts, per fold, the
    sweep launches the fold took part in."""
    n_segments: int = 0
    n_screens: int = 0
    n_compilations: int = 0
    n_rejected: int = 0
    n_pallas_screens: int = 0
    fista_iters: int = 0
    buckets: list = dataclasses.field(default_factory=list)  # (p_b, g_b, m, k)
    fold_sweeps: object = None   # (K,) launch counts from the last fold run

    def merge(self, other: "EngineStats", *, buckets: bool = True) -> None:
        """Accumulate another run's counters into this one, and its bucket
        tuples unless ``buckets=False`` (long-lived aggregates such as a
        session's pass False, so the list cannot grow without bound).  The
        per-run ``fold_sweeps`` are not merged."""
        self.n_segments += other.n_segments
        self.n_screens += other.n_screens
        self.n_compilations += other.n_compilations
        self.n_rejected += other.n_rejected
        self.n_pallas_screens += other.n_pallas_screens
        self.fista_iters += other.fista_iters
        if buckets:
            self.buckets.extend(other.buckets)


def _kernels_active(use_kernels: Optional[bool], dtype, device) -> bool:
    """The kernels are float32: never engaged for float64.  ``None`` means
    float32 on CUDA; ``True`` on the CPU runs their plain versions."""
    if dtype != torch.float32:
        return False
    if use_kernels is None:
        return torch.device(device).type == "cuda"
    return bool(use_kernels)


def _refuse_tf32(X) -> None:
    """The float32 screening margins assume true float32 products."""
    if (X.device.type == "cuda" and X.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the float32 "
            "screening margin assumes true float32 products; turn TF32 off")


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _padded_prox(spec: GroupSpec):
    """The fused SGL prox kernel on the flat vector, through ``spec``'s
    padded view.  Columns no valid slot covers (the garbage bin's columns
    past its first ``n_max``) come out 0, as a scatter-add onto zeros would
    give them."""
    from ..kernels import ops as _kops

    def prox(v, t_l1, t_group):
        return _kops.sgl_prox(v, spec.pad_index, spec.pad_mask,
                              spec.pad_uncovered, t_l1, t_group)

    return prox


def _fista_route(X_sub, sub_spec: GroupSpec, use_kernels: bool,
                 graphs: dict):
    """(solve, kw) for the SGL solves of one reduced problem: replays of
    graphed blocks (``fista_sgl_graphed``, cached in ``graphs``) on the
    card's kernel route; elsewhere on the kernel route ``fista_sgl`` with
    the fused prox (its plain version on the CPU); else ``fista_sgl`` with
    the plain prox.  The fused prox takes one l1 threshold, so a spec with
    feature weights takes the plain prox."""
    fused = use_kernels and sub_spec.feature_weights is None
    if fused and X_sub.device.type == "cuda":
        return fista_sgl_graphed, {"graphs": graphs}
    return fista_sgl, {"prox": _padded_prox(sub_spec) if fused else None}


def _scatter_beta(beta_sub, col_dev, p: int):
    """The full (p,) coefficient vector of a bucketed row, on its device:
    the row's first ``len(col_dev)`` entries go to columns ``col_dev``
    (``None``: the row spans every column already)."""
    if col_dev is None:
        return beta_sub
    out = torch.zeros(p, dtype=beta_sub.dtype, device=beta_sub.device)
    out[col_dev] = beta_sub[:col_dev.shape[0]]
    return out


def _pow2_len(m: int) -> int:
    b = 1
    while b < m:
        b *= 2
    return b


def _pad_grid(lambdas_rem: np.ndarray, dtype, device):
    """(padded device grid, real length) with the tail repeating the last
    lambda — extra rows are computed and discarded on the host slice."""
    L = len(lambdas_rem)
    Lp = _pow2_len(L)
    pad = np.concatenate([lambdas_rem, np.full(Lp - L, lambdas_rem[-1])])
    return torch.as_tensor(pad, dtype=dtype, device=device), L


def _feature_bucket(n_base: int, p: int, min_bucket: int,
                    margin: float) -> int:
    """Next power-of-two bucket with at least ``margin`` fractional slack
    over the safe base set (the slack is filled with speculative groups)."""
    b = min(_bucket(max(n_base, 1), min_bucket), p)
    if b < p and b - n_base < margin * b:
        b = min(b * 2, p)
    return b


def _expand_set(base, fk_np, cap: int):
    """Union nearby grid-screen rows into the base set while it stays under
    ``cap`` features — free lookahead from the one-shot grid screen."""
    S = base.copy()
    for r in range(1, min(len(fk_np), 8)):
        trial = S | fk_np[r]
        if int(trial.sum()) > cap:
            break
        S = trial
    return S


def margin_fill_sgl(S, c_prev_np, gid, sizes_np, weights_np, p_b: int,
                    g_b: int, feature_weights_np=None):
    """Fill spare bucket capacity with whole groups ranked by their dual
    correlation (Lemma-9 margin at the latest exact dual ``c_prev``).
    With adaptive l1 weights the shrinkage threshold is per-feature.
    Mutates ``S``."""
    if S.all():
        return
    G = len(sizes_np)
    thresh = 1.0 if feature_weights_np is None else feature_weights_np
    shr = np.sign(c_prev_np) * np.maximum(np.abs(c_prev_np) - thresh, 0.0)
    score = np.sqrt(np.bincount(gid, weights=shr * shr,
                                minlength=G)) / weights_np
    g_S = np.unique(gid[S])
    in_S = np.zeros(G, dtype=bool)
    in_S[g_S] = True
    n_S, n_grp = int(S.sum()), len(g_S)
    for g in np.argsort(-score):
        if in_S[g]:
            continue
        if n_grp + 1 >= g_b or n_S + int(sizes_np[g]) > p_b:
            continue
        S[gid == g] = True
        in_S[g] = True
        n_S += int(sizes_np[g])
        n_grp += 1


def margin_fill_nn(S, c_prev_np, p_b: int):
    """Fill spare capacity with the top features by dual correlation
    (nonnegative-Lasso analogue of ``margin_fill_sgl``).  Mutates ``S``."""
    spare = p_b - int(S.sum())
    if spare > 0 and not S.all():
        cand = np.asarray(c_prev_np, dtype=float).copy()
        cand[S] = -np.inf
        S[np.argpartition(-cand, spare - 1)[:spare]] = True


def _certified_rows(lams, valid, beta0, tol: float, gap_scale: float,
                    max_iter: int, solve_row):
    """The sweep's row loop, shared by both penalties: solve the rows of
    ``lams`` in order, warm-started, each certified against the full
    problem by ``solve_row(lam, beta) -> (beta, theta, c_theta, gap,
    iters)`` (``gap`` a host float).

    Returns (betas, thetas, cthetas, good, iters): lists over the rows run.
    The sweep stops after the first failed certificate or the first invalid
    row, so the lists may be shorter than the grid; rows not run count as
    not good."""
    betas, thetas, cthetas, goods, iters = [], [], [], [], []
    b = beta0
    for idx in range(lams.shape[0]):
        if not valid[idx]:
            break
        b, theta, ctheta, gap, its = solve_row(lams[idx], b)
        # a max_iter-capped solve only certifies on the provably safe row 0
        good = (gap <= tol * gap_scale * 1.01) or \
            (idx == 0 and its >= max_iter)
        betas.append(b)
        thetas.append(theta)
        cthetas.append(ctheta)
        goods.append(good)
        iters.append(its)
        if not good:
            break
    return betas, thetas, cthetas, goods, iters


def sweep_sgl_core(X, X_sub, y, spec: GroupSpec, sub_spec: GroupSpec, alpha,
                   lipschitz, lams, valid, beta0, tol, gap_scale: float,
                   mu=None, *, max_iter: int, check_every: int,
                   use_kernels: bool, graphs: dict, loss=SQUARED,
                   certify=None):
    """The SGL sweep over the rows of ``lams`` (a device grid; ``valid``
    marks the real rows); see ``_certified_rows``.

    ``use_kernels`` runs the certification GEMV through ``xtv``, and FISTA
    on the route ``_fista_route`` picks: through ``sgl_prox`` when
    ``sub_spec`` carries no feature weights, each row replaying its blocks
    from a CUDA graph in ``graphs`` on the card.

    ``mu`` (optional, (p,)): per-fold column means for leakage-free
    centering.  The certification GEMV runs against the SHARED design, so
    the centered correlation is the rank-one correction
    ``X^T rho - mu * sum(rho)`` (``X_sub`` comes centered and masked).

    ``certify(rho) -> (c, s)`` gives each row's full-problem correlation
    ``c = X^T rho`` and its Lemma-9 dual scaling ``s``; by default the
    GEMV on ``X`` (centered by ``mu``) and ``dual_scaling_sgl`` on
    ``spec``.  The sharded route passes ``cert_sgl`` over the blocks, and
    its ``c`` rows are then stacked (n_local, p_shard)."""
    tol = loss.effective_tol(tol, y.dtype)
    solve, kw = _fista_route(X_sub, sub_spec, use_kernels, graphs)
    kw.update(max_iter=max_iter, check_every=check_every, tol=tol, loss=loss)
    if certify is None:
        certify = _sgl_certifier(X, spec, alpha, mu, use_kernels,
                                 beta0.dtype)

    def solve_row(lam, b):
        res = solve(X_sub, y, sub_spec, lam, alpha, lipschitz, b, **kw)
        theta, ctheta, gap = certify_sgl_row(X_sub, y, sub_spec, alpha, lam,
                                             res.beta, certify, loss)
        return res.beta, theta, ctheta, float(gap), res.iters  # host read

    return _certified_rows(lams, valid, beta0, tol, gap_scale, max_iter,
                           solve_row)


def _sgl_certifier(X, spec: GroupSpec, alpha, mu, use_kernels: bool, dtype):
    """The default ``certify(rho) -> (c, s)`` of ``sweep_sgl_core``: the
    full-X GEMV (centered by ``mu``) and ``dual_scaling_sgl`` on
    ``spec``."""
    def certify(rho):
        c = _xtv(X, rho, use_kernels).to(dtype)             # full-X GEMV
        if mu is not None:
            c = c - (mu * torch.sum(rho)).to(dtype)
        return c, dual_scaling_sgl(spec, c, alpha)
    return certify


def certify_sgl_row(X_sub, y, sub_spec: GroupSpec, alpha, lam, beta,
                    certify, loss=SQUARED):
    """One solved row's certificate against the full problem, on the
    device: (theta, s * c, duality gap).  The sweep reads the gap on the
    host; the resource audit prices the row from this."""
    fit = X_sub @ beta
    resid = loss.residual(y, fit)
    rho = resid / lam
    c, s = certify(rho)
    theta = (s * rho).to(beta.dtype)
    pen = sgl_penalty(sub_spec, beta, alpha)
    pval = loss.primal_value(y, fit, resid) + lam * pen
    dval = loss.dual_value(y, theta, lam)
    return theta, (s * c).to(beta.dtype), pval - dval


def sweep_nn_core(X, X_sub, y, lipschitz, lams, valid, beta0, tol,
                  gap_scale: float, *, max_iter: int, check_every: int,
                  use_kernels: bool, certify=None):
    """The nonnegative-Lasso sweep; see ``_certified_rows``.
    ``certify(rho) -> (c, s)`` as in ``sweep_sgl_core``: by default the
    GEMV on ``X`` and ``dual_scaling_nn``."""
    tol = SQUARED.effective_tol(tol, y.dtype)
    if certify is None:
        certify = _nn_certifier(X, use_kernels, beta0.dtype)

    def solve_row(lam, b):
        res = fista_nn_lasso(X_sub, y, lam, lipschitz, b, max_iter=max_iter,
                             check_every=check_every, tol=tol)
        theta, ctheta, gap = certify_nn_row(X_sub, y, lam, res.beta, certify)
        return res.beta, theta, ctheta, float(gap), res.iters  # host read

    return _certified_rows(lams, valid, beta0, tol, gap_scale, max_iter,
                           solve_row)


def _nn_certifier(X, use_kernels: bool, dtype):
    """The default ``certify(rho) -> (c, s)`` of ``sweep_nn_core``: the
    full-X GEMV and ``dual_scaling_nn``."""
    def certify(rho):
        c = _xtv(X, rho, use_kernels).to(dtype)             # full-X GEMV
        return c, dual_scaling_nn(c)
    return certify


def certify_nn_row(X_sub, y, lam, beta, certify):
    """``certify_sgl_row`` for the nonnegative Lasso."""
    resid = y - X_sub @ beta
    rho = resid / lam
    c, s = certify(rho)
    theta = (s * rho).to(beta.dtype)
    pval = 0.5 * torch.dot(resid, resid) + lam * torch.sum(beta)
    d = y - lam * theta
    dval = 0.5 * torch.dot(y, y) - 0.5 * torch.dot(d, d)
    return theta, (s * c).to(beta.dtype), pval - dval


# The feature-sharded sweeps: the solve bucket stays on one device, and each
# row's full-problem certification runs feature-parallel over the local
# blocks ``Xs`` (``feature_shard.cert_sgl`` / ``cert_nn``).  Squared loss,
# no centering: the fold sweeps keep full-X certification.

def sweep_sgl_core_feat(Xs, X_sub, y, specs, sub_spec: GroupSpec, alpha,
                        lipschitz, lams, valid, beta0, tol,
                        gap_scale: float, *, ops, max_iter: int,
                        check_every: int, use_kernels: bool, graphs: dict):
    from ..distributed.feature_shard import cert_sgl
    return sweep_sgl_core(
        None, X_sub, y, None, sub_spec, alpha, lipschitz, lams, valid, beta0,
        tol, gap_scale, max_iter=max_iter, check_every=check_every,
        use_kernels=use_kernels, graphs=graphs,
        certify=lambda rho: cert_sgl(ops, Xs, specs, rho, alpha, use_kernels))


def sweep_nn_core_feat(Xs, X_sub, y, lipschitz, lams, valid, beta0, tol,
                       gap_scale: float, *, ops, max_iter: int,
                       check_every: int, use_kernels: bool):
    from ..distributed.feature_shard import cert_nn
    return sweep_nn_core(
        None, X_sub, y, lipschitz, lams, valid, beta0, tol, gap_scale,
        max_iter=max_iter, check_every=check_every, use_kernels=use_kernels,
        certify=lambda rho: cert_nn(ops, Xs, rho, use_kernels))


def _feature_plan(feature_shards, p: int, spec: Optional[GroupSpec],
                  mesh=None):
    """(partition, executor) for ``feature_shards > 1`` whose degraded
    shard count stays above 1, else (None, None).  A fold-feature ``mesh``
    whose feature axis has as many ranks as the partition has blocks runs
    them over this rank's feature group; otherwise a world of exactly that
    many ranks does, else the stacked executor."""
    if not feature_shards or int(feature_shards) <= 1:
        return None, None
    from ..distributed import feature_shard as _fs
    fshard = _fs.plan_feature_shards(int(feature_shards), p, spec)
    if fshard.n_shards <= 1:
        return None, None
    if (getattr(mesh, "feature_group", None) is not None
            and mesh.shape.get("feature") == fshard.n_shards):
        return fshard, _fs.feature_ops(fshard.n_shards, mesh.feature_group,
                                       mesh.feature_host_group)
    return fshard, _fs.feature_ops(
        fshard.n_shards, _fs.resolve_feature_mesh(fshard.n_shards))


def sgl_path_batched(X, y, spec: GroupSpec, alpha, *, lambdas=None,
                     n_lambdas: int = 100, min_ratio: float = 0.01,
                     screen: str = "tlfre", tol=1e-9, max_iter: int = 20000,
                     safety: float = 0.0, specnorm_method: str = "power",
                     check_every: int = 10,
                     use_kernels: Optional[bool] = None,
                     min_bucket: int = 64, min_group_bucket: int = 16,
                     margin: float = 0.125, chunk_init: int = 8,
                     feature_shards: int = 0,
                     compile_keys: Optional[set] = None,
                     fista_graphs: Optional[dict] = None,
                     loss=SQUARED) -> PathResult:
    """Batched SGL path: grid screening, speculative bucketed sweeps with
    per-row certification.  ``X``, ``y`` and ``spec`` lie on one device.

    ``screen='gapsafe'`` intersects the TLFre screen with the Gap-Safe ball
    around the latest certified dual (both balls hold the dual optimum).
    ``loss`` (a ``core.losses`` singleton or name) swaps the smooth
    data-fit term; a non-squared loss screens with the Gap-Safe ball only
    (TLFre's Theorem-12 ball is squared-loss algebra).  On the float32
    kernel route ``xtv`` runs for every loss and weighting; ``sgl_prox``
    and ``screen_norms`` take one l1 threshold and run whenever the spec
    has no adaptive feature weights.

    ``use_kernels=True`` with a float64 problem raises ``TypeError``: the
    float32 kernels would void the float64 exactness of the screen.
    ``feature_shards > 1`` runs the screens and the certification over a
    group-aligned column partition (see the module docstring); it takes
    the squared loss without feature weights, else ``ValueError``.
    ``compile_keys`` is an optional persistent set of sweep-shape keys and
    ``fista_graphs`` an optional persistent cache of captured FISTA blocks
    (both owned by ``SGLSession``)."""
    if screen not in ("tlfre", "gapsafe", "none"):
        raise ValueError(f"unknown screen mode {screen!r}")
    loss = get_loss(loss)
    squared = loss.name == "squared"
    if not squared and screen == "tlfre":
        raise ValueError(
            f"screen='tlfre' requires squared loss (Theorem 12 is "
            f"squared-loss algebra); use screen='gapsafe' for {loss.name}")
    if use_kernels and X.dtype == torch.float64:
        _require_f32_for_pallas(X.dtype)
    if X.device != y.device or X.device != spec.device:
        raise ValueError("X, y and the group spec must lie on one device")
    _refuse_tf32(X)
    dev, dtype = X.device, X.dtype
    N, p = X.shape
    G = spec.num_groups
    kernels = _kernels_active(use_kernels, dtype, dev)
    # the fused group statistics take one l1 threshold
    fused_screen = kernels and spec.feature_weights is None
    if feature_shards and int(feature_shards) > 1 and (
            not squared or spec.feature_weights is not None):
        raise ValueError(
            "feature_shards requires squared loss and no adaptive feature "
            "weights (the sharded cert/spec stacking does not carry them)")
    fshard, fops = _feature_plan(feature_shards, p, spec)

    t0 = time.perf_counter()
    r0 = loss.residual_at_zero(y)
    if fshard is not None:
        from ..distributed import feature_shard as _fs
        Xs = fops.blocks(fshard, X)
        specs_s = fops.local(fshard.specs)
        xty_s = _fs.sharded_xtv(fops, Xs, y)
        xty_np = fshard.unshard_features(fops.gather(xty_s))
        xty = torch.as_tensor(xty_np, device=dev)
        lam_max_t, g_star = lambda_max_sgl(spec, xty, alpha)
        lam_max = float(lam_max_t)
        col_n_s = _fs.sharded_column_norms(fops, Xs)
        if specnorm_method == "power":
            gspec_s = _fs.sharded_group_spectral_norms(fops, Xs, specs_s)
        else:
            gspec_s = _fs.sharded_group_frobenius_norms(fops, Xs, specs_s)
        # the Theorem-15 boundary normal X w*: w* lives on the argmax group
        # only, so X w* is one partial-GEMV sum across the blocks
        w_s = shrink(_fs.sharded_xtv(fops, Xs, y / lam_max))
        gid_s = fops.scatter(fshard, spec.group_ids + 1) - 1   # pads -> -1
        n_boundary = _fs.sharded_fit(
            fops, Xs, torch.where(gid_s == g_star, w_s, 0.0))
        L_full = None          # only the full-bucket fallback needs it
    else:
        xty = X.T @ r0
        lam_max_t, g_star = lambda_max_sgl(spec, xty, alpha)
        lam_max = float(lam_max_t)
        col_n = column_norms(X)
        if specnorm_method == "power":
            gspec = group_spectral_norms(X, spec)
        else:
            gspec = group_frobenius_norms(X, spec)
        L_full = spectral_norm(X) ** 2
    _sync(dev)
    setup_time = time.perf_counter() - t0

    if lambdas is None:
        lambdas = default_lambda_grid(lam_max, n_lambdas, min_ratio)
    lambdas = np.asarray(lambdas, dtype=float)
    J = len(lambdas)

    betas = np.zeros((J, p))
    iters = np.zeros(J, dtype=np.int64)
    kept_feat = np.zeros(J, dtype=np.int64)
    kept_grp = np.zeros(J, dtype=np.int64)
    stats = EngineStats()
    screen_time = 0.0
    solve_time = 0.0
    gid = spec.group_ids.cpu().numpy()
    sizes_np = spec.sizes.cpu().numpy()
    weights_np = spec.weights.cpu().numpy()
    fw_np = (None if spec.feature_weights is None
             else spec.feature_weights.cpu().numpy())
    gap_scale = loss.gap_scale_host(y)

    theta_bar = r0 / lam_max            # exact dual at lam_max (Thm 8)
    if fshard is not None:
        c_prev_s = xty_s / lam_max      # stacked (n_local, p_shard)
        c_prev = xty_np / lam_max       # host view for the margin ranking
    else:
        c_prev = xty / lam_max          # X^T theta_bar
    lam_bar = lam_max
    beta_dev = torch.zeros(p, dtype=dtype, device=dev)   # Gap-Safe only
    beta_full = np.zeros(p)
    seen_keys = compile_keys if compile_keys is not None else set()
    graphs = fista_graphs if fista_graphs is not None else {}
    spec_m = max(int(chunk_init), 1)

    j = 0
    while j < J and lambdas[j] >= lam_max * (1.0 - 1e-12):
        j += 1                          # beta* = 0 at/above lam_max

    while j < J:
        rem, L_rem = _pad_grid(lambdas[j:], dtype, dev)
        # ---- screen the whole remaining grid in one shot ----------------
        ts = time.perf_counter()
        if screen == "none":
            fk_np = np.ones((J - j, p), dtype=bool)
        elif fshard is not None:
            # the boundary normal at lam_max was computed sharded in setup
            at_max = lam_bar >= lam_max * (1.0 - 1e-12)
            n_vec = n_boundary if at_max else y / lam_bar - theta_bar
            _, fk_s, _ = tlfre_screen_grid_feat(
                fops, Xs, specs_s, y, alpha, rem, theta_bar, n_vec, col_n_s,
                gspec_s, safety=safety, use_kernels=fused_screen)
            if screen == "gapsafe":
                beta_s = fops.scatter(fshard, torch.as_tensor(
                    beta_full, dtype=dtype, device=dev))
                radii = gap_safe_grid_radii(
                    y, rem, theta_bar, y - _fs.sharded_fit(fops, Xs, beta_s),
                    sgl_penalty(spec, beta_dev, alpha)) * (1.0 + safety)
                _, fk_dyn_s = gap_safe_screen_grid_feat(
                    fops, specs_s, alpha, c_prev_s, radii, col_n_s, gspec_s,
                    use_kernels=fused_screen)
                fk_s = fk_s & fk_dyn_s
            fk_np = fshard.unshard_features(
                fops.gather(fk_s))[:L_rem]           # one host read
            stats.n_screens += 1
            stats.n_pallas_screens += int(fused_screen)
        elif not squared:
            # no Theorem-12 ball: the Gap-Safe ball around the latest
            # certified dual is the only safe rule
            fit = X @ beta_dev
            resid = loss.residual(y, fit)
            radii = gap_safe_grid_radii_loss(
                loss, y, rem, theta_bar, fit, resid,
                sgl_penalty(spec, beta_dev, alpha)) * (1.0 + safety)
            _, fk = gap_safe_screen_grid(spec, alpha, c_prev, radii, col_n,
                                         gspec, use_kernels=fused_screen)
            fk_np = fk[:L_rem].cpu().numpy()        # one host read
            stats.n_screens += 1
            stats.n_pallas_screens += int(fused_screen)
        else:
            n_vec = normal_vector_sgl(X, y, spec, lam_bar, lam_max,
                                      theta_bar, g_star)
            _, fk, _ = tlfre_screen_grid(
                X, y, spec, alpha, rem, lam_bar, theta_bar, n_vec, col_n,
                gspec, safety=safety, use_kernels=fused_screen)
            if screen == "gapsafe":
                # both balls hold the dual optimum, so their intersection
                # screens harder than either alone
                radii = gap_safe_grid_radii(
                    y, rem, theta_bar, y - X @ beta_dev,
                    sgl_penalty(spec, beta_dev, alpha)) * (1.0 + safety)
                _, fk_dyn = gap_safe_screen_grid(spec, alpha, c_prev, radii,
                                                 col_n, gspec,
                                                 use_kernels=fused_screen)
                fk = fk & fk_dyn
            fk_np = fk[:L_rem].cpu().numpy()        # one host read
            stats.n_screens += 1
            stats.n_pallas_screens += int(fused_screen)
        screen_time += time.perf_counter() - ts

        row_counts = fk_np.sum(axis=1)
        if row_counts[0] == 0:
            # fully-screened prefix: beta* = 0 and the dual optimum is y/lam
            k = (int(np.argmax(row_counts > 0)) if row_counts.any()
                 else len(row_counts))
            lam_bar = float(lambdas[j + k - 1])
            theta_bar = r0 / lam_bar
            if fshard is not None:
                c_prev_s = xty_s / lam_bar
                c_prev = xty_np / lam_bar
            else:
                c_prev = xty / lam_bar
            beta_dev = torch.zeros(p, dtype=dtype, device=dev)
            beta_full = np.zeros(p)
            j += k
            continue

        # ---- feature set: safe base + nearby-row union + ranked margin --
        base = fk_np[0]
        n_base = int(base.sum())
        p_b = _feature_bucket(n_base, p, min_bucket, margin)
        S = _expand_set(base, fk_np, p_b)
        g_S = np.unique(gid[S])
        g_b = min(_bucket(len(g_S) + 2, min_group_bucket), G + 1)
        margin_fill_sgl(S, c_prev if fshard is not None
                        else c_prev.cpu().numpy(), gid, sizes_np,
                        weights_np, p_b, g_b, fw_np)

        m = min(J - j, spec_m)

        # ---- bucketed reduced problem + one sweep over the chunk --------
        ts = time.perf_counter()
        if S.all():
            sub_spec, col_idx, col_dev = spec, np.arange(p), None
            if L_full is None:
                L_full = spectral_norm(X) ** 2
            X_sub, L_sub = X, L_full
            p_b, g_b = p, G
        else:
            sub_spec, col_idx = spec.bucketed_subset(S, p_b, g_b)
            col_dev = torch.as_tensor(col_idx, device=dev)
            X_sub = torch.zeros((N, p_b), dtype=dtype, device=dev)
            X_sub[:, :len(col_idx)] = X[:, col_dev]
            L_sub = spectral_norm(X_sub, iters=25) ** 2
        beta0 = np.zeros(p_b)
        beta0[:len(col_idx)] = beta_full[col_idx]

        lam_chunk = lambdas[j:j + m]
        len2 = _pow2_len(m)
        lam_pad = np.concatenate(
            [lam_chunk, np.full(len2 - m, lam_chunk[-1])])
        valid = np.arange(len2) < m
        # the reference's compile key: every dim its jit cache
        # discriminates on, so n_compilations counts the same shapes; the
        # sharded key carries the shard count and whether a process group
        # runs the blocks
        if fshard is not None:
            key = ("sgl-feat", fshard.n_shards, N, p, G, str(dtype),
                   max_iter, check_every, fops.group is not None, kernels,
                   p_b, sub_spec.num_groups, sub_spec.max_size, len2,
                   loss.name)
        else:
            key = ("sgl", N, p, G, str(dtype), max_iter, check_every,
                   kernels, p_b, sub_spec.num_groups, sub_spec.max_size,
                   len2, loss.name)
        if key not in seen_keys:
            seen_keys.add(key)
            stats.n_compilations += 1
        lams_d = torch.as_tensor(lam_pad, dtype=dtype, device=dev)
        beta0_d = torch.as_tensor(beta0, dtype=dtype, device=dev)
        if fshard is not None:
            betas_b, thetas_b, cthetas_b, good_b, iters_b = \
                sweep_sgl_core_feat(
                    Xs, X_sub, y, specs_s, sub_spec, alpha, L_sub, lams_d,
                    valid, beta0_d, tol, gap_scale, ops=fops,
                    max_iter=max_iter, check_every=check_every,
                    use_kernels=kernels, graphs=graphs)
        else:
            betas_b, thetas_b, cthetas_b, good_b, iters_b = sweep_sgl_core(
                X, X_sub, y, spec, sub_spec, alpha, L_sub, lams_d, valid,
                beta0_d, tol, gap_scale, max_iter=max_iter,
                check_every=check_every, use_kernels=kernels, graphs=graphs,
                loss=loss)
        good_np = np.zeros(m, dtype=bool)
        good_np[:len(good_b)] = good_b[:m]
        k = int(np.argmin(good_np)) if not good_np.all() else m
        if k == 0:
            # cannot happen for a converged row 0 (its set is provably
            # safe); belt-and-braces progress guarantee
            k = 1
        stats.n_rejected += int(m - k)
        stats.fista_iters += int(sum(iters_b))
        theta_bar = thetas_b[k - 1]
        if fshard is not None:
            c_prev_s = cthetas_b[k - 1]
            c_prev = fshard.unshard_features(fops.gather(c_prev_s))
        else:
            c_prev = cthetas_b[k - 1]
        betas_np = torch.stack(betas_b[:k]).cpu().numpy()
        solve_time += time.perf_counter() - ts

        chunk_rows = np.zeros((k, p))
        chunk_rows[:, col_idx] = betas_np[:, :len(col_idx)]
        betas[j:j + k] = chunk_rows
        iters[j:j + k] = iters_b[:k]
        kept_feat[j:j + k] = len(col_idx)       # columns entering the solver
        kept_grp[j:j + k] = len(np.unique(gid[S]))
        beta_full = chunk_rows[-1]
        if screen == "gapsafe":         # the next screen's radii read it
            beta_dev = _scatter_beta(betas_b[k - 1], col_dev, p)
        lam_bar = float(lam_chunk[k - 1])
        stats.n_segments += 1
        stats.buckets.append((p_b, g_b, m, k))
        spec_m = min(2 * spec_m, 64) if k == m else max(2, k)
        j += k

    return PathResult(lambdas=lambdas, betas=betas, lam_max=lam_max,
                      screen_time=screen_time, solve_time=solve_time,
                      setup_time=setup_time, iters=iters,
                      kept_features=kept_feat, kept_groups=kept_grp,
                      stats=stats)


# ---------------------------------------------------------------------------
# Nonnegative Lasso
# ---------------------------------------------------------------------------

def nn_lasso_path_batched(X, y, *, lambdas=None, n_lambdas: int = 100,
                          min_ratio: float = 0.01, screen: str = "dpc",
                          tol=1e-9, max_iter: int = 20000,
                          safety: float = 0.0, check_every: int = 10,
                          use_kernels: Optional[bool] = None,
                          min_bucket: int = 64, margin: float = 0.125,
                          chunk_init: int = 8, feature_shards: int = 0,
                          compile_keys: Optional[set] = None) -> PathResult:
    """Batched nonnegative-Lasso path: whole-grid DPC screens, speculative
    bucketed sweeps with per-row certification.  ``screen='gapsafe'``
    intersects the DPC screen with the Gap-Safe ball around the latest
    certified dual.  ``use_kernels`` / ``feature_shards`` /
    ``compile_keys`` as in ``sgl_path_batched`` (the partition is
    singleton-column: equal blocks of the largest shard count that divides
    p); the only kernel on this path is the ``xtv`` certification GEMV."""
    if screen not in ("dpc", "gapsafe", "none"):
        raise ValueError(f"unknown screen mode {screen!r}")
    if use_kernels and X.dtype == torch.float64:
        _require_f32_for_pallas(X.dtype)
    if X.device != y.device:
        raise ValueError("X and y must lie on one device")
    _refuse_tf32(X)
    dev, dtype = X.device, X.dtype
    N, p = X.shape
    kernels = _kernels_active(use_kernels, dtype, dev)
    fshard, fops = _feature_plan(feature_shards, p, None)

    t0 = time.perf_counter()
    if fshard is not None:
        from ..distributed import feature_shard as _fs
        Xs = fops.blocks(fshard, X)
        xty_s = _fs.sharded_xtv(fops, Xs, y)
        xty_np = fshard.unshard_features(fops.gather(xty_s))
        xty = torch.as_tensor(xty_np, device=dev)
        lam_max_t, i_star = lambda_max_nn(xty)
        col_n_s = _fs.sharded_column_norms(fops, Xs)
        # the Theorem-21 boundary normal is the argmax column
        x_star = X[:, int(i_star)]
        L_full = None
    else:
        xty = X.T @ y
        lam_max_t, i_star = lambda_max_nn(xty)
        col_n = column_norms(X)
        L_full = spectral_norm(X) ** 2
    lam_max = float(lam_max_t)
    _sync(dev)
    if lam_max <= 0:
        raise ValueError("max_i <x_i, y> <= 0: nonnegative Lasso solution is "
                         "identically zero for every lambda > 0")
    setup_time = time.perf_counter() - t0

    if lambdas is None:
        lambdas = default_lambda_grid(lam_max, n_lambdas, min_ratio)
    lambdas = np.asarray(lambdas, dtype=float)
    J = len(lambdas)

    betas = np.zeros((J, p))
    iters = np.zeros(J, dtype=np.int64)
    kept_feat = np.zeros(J, dtype=np.int64)
    stats = EngineStats()
    screen_time = 0.0
    solve_time = 0.0
    gap_scale = SQUARED.gap_scale_host(y)

    theta_bar = y / lam_max
    if fshard is not None:
        c_prev_s = xty_s / lam_max
        c_prev = xty_np / lam_max
    else:
        c_prev = xty / lam_max
    lam_bar = lam_max
    beta_dev = torch.zeros(p, dtype=dtype, device=dev)
    beta_full = np.zeros(p)
    seen_keys = compile_keys if compile_keys is not None else set()
    spec_m = max(int(chunk_init), 1)

    j = 0
    while j < J and lambdas[j] >= lam_max * (1.0 - 1e-12):
        j += 1

    while j < J:
        rem, L_rem = _pad_grid(lambdas[j:], dtype, dev)
        ts = time.perf_counter()
        if screen == "none":
            fk_np = np.ones((J - j, p), dtype=bool)
        elif fshard is not None:
            at_max = lam_bar >= lam_max * (1.0 - 1e-12)
            n_vec = x_star if at_max else y / lam_bar - theta_bar
            fk_s, _ = dpc_screen_grid_feat(fops, Xs, y, rem, theta_bar,
                                           n_vec, col_n_s, safety=safety)
            if screen == "gapsafe":
                beta_s = fops.scatter(fshard, torch.as_tensor(
                    beta_full, dtype=dtype, device=dev))
                radii = gap_safe_grid_radii(
                    y, rem, theta_bar, y - _fs.sharded_fit(fops, Xs, beta_s),
                    torch.sum(beta_dev)) * (1.0 + safety)   # beta >= 0
                fk_s = fk_s & gap_safe_screen_grid_nn_feat(fops, c_prev_s,
                                                           radii, col_n_s)
            fk_np = fshard.unshard_features(
                fops.gather(fk_s))[:L_rem]           # one host read
            stats.n_screens += 1
        else:
            n_vec = normal_vector_nn(X, y, lam_bar, lam_max, theta_bar,
                                     i_star)
            fk, _ = dpc_screen_grid(X, y, rem, theta_bar, n_vec, col_n,
                                    safety=safety)
            if screen == "gapsafe":
                radii = gap_safe_grid_radii(
                    y, rem, theta_bar, y - X @ beta_dev,
                    torch.sum(beta_dev)) * (1.0 + safety)   # beta >= 0
                fk = fk & gap_safe_screen_grid_nn(c_prev, radii, col_n)
            fk_np = fk[:L_rem].cpu().numpy()        # one host read
            stats.n_screens += 1
        screen_time += time.perf_counter() - ts

        row_counts = fk_np.sum(axis=1)
        if row_counts[0] == 0:
            k = (int(np.argmax(row_counts > 0)) if row_counts.any()
                 else len(row_counts))
            lam_bar = float(lambdas[j + k - 1])
            theta_bar = y / lam_bar
            if fshard is not None:
                c_prev_s = xty_s / lam_bar
                c_prev = xty_np / lam_bar
            else:
                c_prev = xty / lam_bar
            beta_dev = torch.zeros(p, dtype=dtype, device=dev)
            beta_full = np.zeros(p)
            j += k
            continue

        base = fk_np[0]
        n_base = int(base.sum())
        p_b = _feature_bucket(n_base, p, min_bucket, margin)
        S = _expand_set(base, fk_np, p_b)
        margin_fill_nn(S, c_prev if fshard is not None
                       else c_prev.cpu().numpy(), p_b)

        m = min(J - j, spec_m)

        ts = time.perf_counter()
        if S.all():
            col_idx, col_dev = np.arange(p), None
            if L_full is None:
                L_full = spectral_norm(X) ** 2
            X_sub, L_sub = X, L_full
            p_b = p
        else:
            col_idx = np.nonzero(S)[0]
            col_dev = torch.as_tensor(col_idx, device=dev)
            X_sub = torch.zeros((N, p_b), dtype=dtype, device=dev)
            X_sub[:, :len(col_idx)] = X[:, col_dev]
            L_sub = spectral_norm(X_sub, iters=25) ** 2
        beta0 = np.zeros(p_b)
        beta0[:len(col_idx)] = beta_full[col_idx]

        lam_chunk = lambdas[j:j + m]
        len2 = _pow2_len(m)
        lam_pad = np.concatenate(
            [lam_chunk, np.full(len2 - m, lam_chunk[-1])])
        valid = np.arange(len2) < m
        if fshard is not None:
            key = ("nn-feat", fshard.n_shards, N, p, str(dtype), max_iter,
                   check_every, fops.group is not None, kernels, p_b, len2,
                   "squared")
        else:
            key = ("nn", N, p, str(dtype), max_iter, check_every, kernels,
                   p_b, len2, "squared")
        if key not in seen_keys:
            seen_keys.add(key)
            stats.n_compilations += 1
        lams_d = torch.as_tensor(lam_pad, dtype=dtype, device=dev)
        beta0_d = torch.as_tensor(beta0, dtype=dtype, device=dev)
        if fshard is not None:
            betas_b, thetas_b, cthetas_b, good_b, iters_b = \
                sweep_nn_core_feat(
                    Xs, X_sub, y, L_sub, lams_d, valid, beta0_d, tol,
                    gap_scale, ops=fops, max_iter=max_iter,
                    check_every=check_every, use_kernels=kernels)
        else:
            betas_b, thetas_b, cthetas_b, good_b, iters_b = sweep_nn_core(
                X, X_sub, y, L_sub, lams_d, valid, beta0_d, tol, gap_scale,
                max_iter=max_iter, check_every=check_every,
                use_kernels=kernels)
        good_np = np.zeros(m, dtype=bool)
        good_np[:len(good_b)] = good_b[:m]
        k = int(np.argmin(good_np)) if not good_np.all() else m
        if k == 0:
            k = 1
        stats.n_rejected += int(m - k)
        stats.fista_iters += int(sum(iters_b))
        theta_bar = thetas_b[k - 1]
        if fshard is not None:
            c_prev_s = cthetas_b[k - 1]
            c_prev = fshard.unshard_features(fops.gather(c_prev_s))
        else:
            c_prev = cthetas_b[k - 1]
        betas_np = torch.stack(betas_b[:k]).cpu().numpy()
        solve_time += time.perf_counter() - ts

        chunk_rows = np.zeros((k, p))
        chunk_rows[:, col_idx] = betas_np[:, :len(col_idx)]
        betas[j:j + k] = chunk_rows
        iters[j:j + k] = iters_b[:k]
        kept_feat[j:j + k] = len(col_idx)       # columns entering the solver
        beta_full = chunk_rows[-1]
        if screen == "gapsafe":
            beta_dev = _scatter_beta(betas_b[k - 1], col_dev, p)
        lam_bar = float(lam_chunk[k - 1])
        stats.n_segments += 1
        stats.buckets.append((p_b, 0, m, k))
        spec_m = min(2 * spec_m, 64) if k == m else max(2, k)
        j += k

    return PathResult(lambdas=lambdas, betas=betas, lam_max=lam_max,
                      screen_time=screen_time, solve_time=solve_time,
                      setup_time=setup_time, iters=iters,
                      kept_features=kept_feat, stats=stats)
