"""FISTA for SGL (3) and the nonnegative Lasso (80), PyTorch port, with
duality-gap stopping.

The dual point used in the gap is the residual scaled onto the feasible set
with the Lemma-9 root machinery (``lambda_max.dual_scaling_sgl``), so the
reported gaps are true optimality certificates.

The reference's ``lax.while_loop`` over ``lax.scan`` chunks becomes a Python
loop over device tensors: ``check_every`` iterations run without a host
read, then the gap is computed and read on the host once.  Iteration counts
therefore match the reference's (multiples of ``check_every``).  On the card,
with the fused prox kernel, ``fista_sgl_graphed`` replays each such block
(the gap included) from one captured CUDA graph: the port's counterpart of
the reference's compiled scan.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import dpc as _dpc
from .fenchel import sgl_penalty
from .groups import GroupSpec
from .lambda_max import dual_scaling_sgl
from .losses import SQUARED
from .prox import nn_lasso_prox, sgl_prox


class SolveResult(NamedTuple):
    beta: torch.Tensor
    theta: torch.Tensor         # feasible dual point (y - X beta)/lam, scaled
    gap: torch.Tensor
    iters: int


def _sgl_gap(X, y, spec, lam, alpha, beta, loss=SQUARED):
    """(primal, dual, theta_feasible) at beta."""
    fit = X @ beta
    resid = loss.residual(y, fit)
    rho = resid / lam
    s = dual_scaling_sgl(spec, X.T @ rho, alpha)
    theta = s * rho
    p = loss.primal_value(y, fit, resid) + lam * sgl_penalty(spec, beta, alpha)
    d = loss.dual_value(y, theta, lam)
    return p, d, theta


def fista_sgl(X, y, spec: GroupSpec, lam, alpha, lipschitz, beta0, *,
              max_iter: int = 20000, check_every: int = 10, tol: float = 1e-9,
              prox=None, loss=SQUARED) -> SolveResult:
    """FISTA with O'Donoghue-Candes adaptive restart for problem (3).

    ``lam`` and ``lipschitz`` (the design bound ``||X||^2`` for every
    loss; the loss's smoothness ``gamma`` is applied here) are scalars or
    0-d tensors.  ``prox`` optionally overrides the
    ``(z, t_l1, t_group) -> z'`` proximal step — the engine injects the
    fused CUDA kernel here; ``t_l1`` reaches it as a 1-element device
    tensor, or as a (p,) tensor of per-feature thresholds when the spec
    carries adaptive feature weights (the engine runs the plain prox then).
    The gap is read on the host once every ``check_every`` iterations and
    tested against ``tol * gap_scale``.
    """
    dtype, dev = X.dtype, X.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    lipschitz = torch.as_tensor(lipschitz, dtype=dtype, device=dev)
    if loss.gamma != 1.0:
        lipschitz = lipschitz * loss.gamma
    beta0 = beta0.to(dtype)
    tol = loss.effective_tol(tol, dtype)
    t_step = 1.0 / lipschitz
    if spec.feature_weights is None:
        t_l1 = (t_step * lam).reshape(1)           # lam2 = lam
    else:
        t_l1 = t_step * lam * spec.feature_weights.to(dtype)
    t_group = t_step * lam * alpha * spec.weights.to(dtype)
    threshold = tol * loss.gap_scale(y)
    if prox is None:
        prox = lambda v, a, b: sgl_prox(spec, v, a, b)   # noqa: E731

    beta, z = beta0, beta0
    tk = torch.ones((), dtype=dtype, device=dev)
    it = 0
    gap = torch.full((), float("inf"), dtype=dtype, device=dev)
    theta = None
    while it < max_iter and bool(gap > threshold):
        beta, z, tk = _sgl_block(X, y, t_step, t_l1, t_group, prox, beta, z,
                                 tk, check_every, loss)
        pval, dval, theta = _sgl_gap(X, y, spec, lam, alpha, beta, loss)
        it += check_every
        gap = (pval - dval).to(dtype)
    if theta is None:                   # max_iter <= 0: no check ran
        _, _, theta = _sgl_gap(X, y, spec, lam, alpha, beta, loss)
    return SolveResult(beta, theta, gap, it)


def _sgl_block(X, y, t_step, t_l1, t_group, prox, beta, z, tk, n: int,
               loss):
    """``n`` FISTA iterations from the carries (beta, z, tk); returns the
    new carries.  The eager solver and the captured block both run this."""
    for _ in range(n):
        g = X.T @ loss.grad(y, X @ z)
        beta_new = prox(z - t_step * g, t_l1, t_group).to(X.dtype)
        # adaptive restart: reset momentum when the extrapolated direction
        # opposes progress
        restart = torch.dot(z - beta_new, beta_new - beta) > 0
        tk = torch.where(restart, 1.0, tk)
        tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        z = beta_new + ((tk - 1.0) / tk1) * (beta_new - beta)
        beta, tk = beta_new, tk1
    return beta, z, tk


def solve_sgl(X, y, spec: GroupSpec, lam, alpha, lipschitz, beta0=None, *,
              max_iter: int = 20000, check_every: int = 10,
              tol: float = 1e-9, loss=SQUARED, use_kernels: bool = False,
              graphs=None) -> SolveResult:
    """FISTA for problem (3) from ``beta0`` (zero by default).  ``tol`` is
    a relative duality-gap tolerance (gap <= tol * loss.gap_scale(y);
    0.5||y||^2 for the squared loss); ``lipschitz`` is the design bound
    ``||X||^2`` for every loss.

    ``use_kernels`` (float32 only: a float64 input raises ``TypeError``)
    takes the path engine's route: without feature weights, through the
    fused ``sgl_prox``, replayed from graphed blocks on the card (cached in
    ``graphs``; a fresh cache by default) and eager through its plain
    version on the CPU; with feature weights, the eager loop with the
    plain prox."""
    from .path_engine import _fista_route   # path_engine imports this module
    from .screening import _require_f32_for_pallas
    if use_kernels:
        _require_f32_for_pallas(X.dtype)
    if beta0 is None:
        beta0 = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    solve, kw = _fista_route(X, spec, use_kernels,
                             {} if graphs is None else graphs)
    return solve(X, y, spec, lam, alpha, lipschitz, beta0, max_iter=max_iter,
                 check_every=check_every, tol=tol, loss=loss, **kw)


# ---------------------------------------------------------------------------
# The FISTA block as a CUDA graph (the card's kernel route)
# ---------------------------------------------------------------------------

def _tensor_fields(spec: GroupSpec) -> list:
    return [f.name for f in dataclasses.fields(spec)
            if isinstance(getattr(spec, f.name), torch.Tensor)]


class _SGLBlockGraph:
    """``check_every`` iterations of ``fista_sgl`` and the gap at their end,
    captured as one CUDA graph on static buffers.  ``bind`` copies a
    solve's inputs and starting carries in; each ``replay`` advances the
    carries (beta, z, tk) by one block and rewrites ``gap`` and ``theta``."""

    def __init__(self, X, y, spec: GroupSpec, lam, check_every: int, loss):
        from ..kernels import ops as kops
        e = torch.empty_like
        self.check_every, self.loss, self._kops = check_every, loss, kops
        self.X, self.y = e(X), e(y)
        self.spec = dataclasses.replace(spec, **{
            f: e(getattr(spec, f)) for f in _tensor_fields(spec)})
        self.lam, self.alpha, self.t_step, self.tk, self.gap = (
            e(lam) for _ in range(5))
        self.t_l1 = torch.empty(1, dtype=X.dtype, device=X.device)
        self.t_group = torch.empty(spec.num_groups, dtype=X.dtype,
                                   device=X.device)
        self.beta, self.z = e(X[0]), e(X[0])
        self.theta = e(y)
        s = self.spec
        self._prox = lambda v, a, b: kops.sgl_prox(   # noqa: E731
            v, s.pad_index, s.pad_mask, s.pad_uncovered, a, b)
        self.graph = None
        self.recorded = {}      # {kernel name: calls} one replay launches

    def bind(self, X, y, spec, lam, alpha, t_step, t_l1, t_group, beta0):
        self.X.copy_(X)
        self.y.copy_(y)
        for f in _tensor_fields(spec):
            getattr(self.spec, f).copy_(getattr(spec, f))
        self.lam.copy_(lam)
        self.alpha.fill_(alpha)
        self.t_step.copy_(t_step)
        self.t_l1.copy_(t_l1)
        self.t_group.copy_(t_group)
        self.beta.copy_(beta0)
        self.z.copy_(beta0)
        self.tk.fill_(1.0)

    def _block(self):
        beta, z, tk = _sgl_block(self.X, self.y, self.t_step, self.t_l1,
                                 self.t_group, self._prox, self.beta, self.z,
                                 self.tk, self.check_every, self.loss)
        pval, dval, theta = _sgl_gap(self.X, self.y, self.spec, self.lam,
                                     self.alpha, beta, self.loss)
        self.beta.copy_(beta)
        self.z.copy_(z)
        self.tk.copy_(tk)
        self.gap.copy_((pval - dval).to(self.gap.dtype))
        self.theta.copy_(theta)

    def capture(self):
        """Run the bound solve's first block eagerly on a side stream (the
        warm-up that cuBLAS and the kernel library need before a capture;
        its launches are real and counted), then capture the block.  The
        kernel calls the capture recorded are counted, and must be one
        ``sgl_prox`` per iteration and nothing else."""
        dev = self.X.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._block()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = self._kops.captured_counts()
        with torch.cuda.graph(graph):
            self._block()
        after = self._kops.captured_counts()
        recorded = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        if recorded != {"sgl_prox": self.check_every}:
            raise RuntimeError(
                f"the captured FISTA block recorded the kernel calls "
                f"{recorded}, not {self.check_every} of sgl_prox")
        self.graph, self.recorded = graph, recorded

    def replay(self):
        self.graph.replay()
        self._kops.count_replay(self.recorded)


def fista_sgl_graphed(X, y, spec: GroupSpec, lam, alpha, lipschitz, beta0,
                      *, graphs: dict, max_iter: int = 20000,
                      check_every: int = 10, tol: float = 1e-9,
                      loss=SQUARED) -> SolveResult:
    """``fista_sgl`` through the fused ``sgl_prox`` kernel, with each block
    of ``check_every`` iterations and the gap at its end replayed from a
    CUDA graph.  ``graphs`` caches the captured blocks by ``(N, p_b, g_b,
    n_max, dtype, check_every, loss, device)``; a solve of a new shape
    captures one.  ``SGLSession`` owns the cache, beside its
    ``compile_keys``, so a warm call captures nothing; the key is coarser
    than the engine's compile keys, so every capture coincides with a
    counted compilation.  The host reads the gap once per block, as
    ``fista_sgl`` does, so the iterates and iteration counts are the same.
    Card, float32 and unit l1 weights only (the kernel takes one l1
    threshold); any loss, whose ``gamma`` scales the step as in
    ``fista_sgl``.  A failed capture raises."""
    dtype, dev = X.dtype, X.device
    if dev.type != "cuda" or dtype != torch.float32:
        raise ValueError("the graphed FISTA block runs float32 on the card")
    if spec.feature_weights is not None:
        raise ValueError("the graphed FISTA block takes one l1 threshold "
                         "(no feature weights)")
    if max_iter <= 0:                   # no block runs
        return fista_sgl(X, y, spec, lam, alpha, lipschitz, beta0,
                         max_iter=max_iter, tol=tol, loss=loss)
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    lipschitz = torch.as_tensor(lipschitz, dtype=dtype, device=dev)
    if loss.gamma != 1.0:
        lipschitz = lipschitz * loss.gamma
    tol = loss.effective_tol(tol, dtype)
    t_step = 1.0 / lipschitz
    t_l1 = (t_step * lam).reshape(1)
    t_group = t_step * lam * alpha * spec.weights.to(dtype)
    threshold = tol * loss.gap_scale(y)

    key = (X.shape[0], X.shape[1], spec.num_groups, spec.max_size,
           str(dtype), check_every, loss.name, str(dev))
    block = graphs.get(key)
    if block is None:
        block = _SGLBlockGraph(X, y, spec, lam, check_every, loss)
    block.bind(X, y, spec, lam, alpha, t_step, t_l1, t_group,
               beta0.to(dtype))
    if block.graph is None:
        block.capture()                 # runs the first block
        graphs[key] = block
    else:
        block.replay()
    it = check_every
    while it < max_iter and bool(block.gap > threshold):
        block.replay()
        it += check_every
    return SolveResult(block.beta.clone(), block.theta.clone(),
                       block.gap.clone(), it)


# ---------------------------------------------------------------------------
# Nonnegative Lasso
# ---------------------------------------------------------------------------

def _nn_gap(X, y, lam, beta):
    """(primal, dual, theta_feasible) at beta for problem (80)."""
    rho = (y - X @ beta) / lam
    s = _dpc.dual_scaling_nn(X.T @ rho)
    theta = s * rho
    p = _dpc.nn_primal_objective(X, y, beta, lam)
    d = _dpc.nn_dual_objective(y, theta, lam)
    return p, d, theta


def _nn_block(X, y, t_step, t_lam, beta, z, tk, n: int):
    """``n`` FISTA iterations of problem (80) from the carries (beta, z,
    tk), with ``_sgl_block``'s restart rule; returns the new carries."""
    for _ in range(n):
        g = X.T @ (X @ z - y)
        beta_new = nn_lasso_prox(z - t_step * g, t_lam)
        restart = torch.dot(z - beta_new, beta_new - beta) > 0
        tk = torch.where(restart, 1.0, tk)
        tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        z = beta_new + ((tk - 1.0) / tk1) * (beta_new - beta)
        beta, tk = beta_new, tk1
    return beta, z, tk


def fista_nn_lasso(X, y, lam, lipschitz, beta0, *, max_iter: int = 20000,
                   check_every: int = 10, tol: float = 1e-9) -> SolveResult:
    """FISTA with adaptive restart for problem (80), prox (v - t*lam)_+.

    The same restart rule and the same gap test every ``check_every``
    iterations (against ``tol * 0.5||y||^2``) as ``fista_sgl``."""
    dtype, dev = X.dtype, X.device
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    lipschitz = torch.as_tensor(lipschitz, dtype=dtype, device=dev)
    beta0 = beta0.to(dtype)
    tol = SQUARED.effective_tol(tol, dtype)
    t_step = 1.0 / lipschitz
    t_lam = t_step * lam
    threshold = tol * SQUARED.gap_scale(y)

    beta, z = beta0, beta0
    tk = torch.ones((), dtype=dtype, device=dev)
    it = 0
    gap = torch.full((), float("inf"), dtype=dtype, device=dev)
    theta = None
    while it < max_iter and bool(gap > threshold):
        beta, z, tk = _nn_block(X, y, t_step, t_lam, beta, z, tk,
                                check_every)
        pval, dval, theta = _nn_gap(X, y, lam, beta)
        it += check_every
        gap = (pval - dval).to(dtype)
    if theta is None:                   # max_iter <= 0: no check ran
        _, _, theta = _nn_gap(X, y, lam, beta)
    return SolveResult(beta, theta, gap, it)


def solve_nn_lasso(X, y, lam, lipschitz, beta0=None, *,
                   max_iter: int = 20000, check_every: int = 10,
                   tol: float = 1e-9) -> SolveResult:
    """FISTA for problem (80) with prox (v - t*lam)_+, from ``beta0``
    (zero by default)."""
    if beta0 is None:
        beta0 = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    return fista_nn_lasso(X, y, lam, lipschitz, beta0, max_iter=max_iter,
                          check_every=check_every, tol=tol)
