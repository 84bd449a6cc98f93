"""Group-aligned column sharding of the design matrix for feature-parallel
two-layer screening (TLFre Thms 15/16, DPC Thm 22, Gap-Safe); PyTorch port
of ``repro.distributed.feature_shard``.

Every screening quantity (the per-segment ``(K*L, N) x (N, p)`` grid GEMM,
the group statistics, the Theorem-22 threshold and the certification GEMV
``X^T rho``) is independent per feature and per group, so a column
partition of X runs them block by block.  The solve bucket stays on one
device: its columns are gathered from the full X as in the unsharded
engine.

Partition layout
----------------
Shard ``s`` of ``S`` owns the contiguous group block ``[s*G/S,
(s+1)*G/S)``: a group is never split, so every per-group quantity (shrink
roots, group norms, spectral norms) comes from the shard's own columns.
``S`` degrades to the largest count that divides the group count (the
feature count for the nonnegative Lasso), by ``sharding.divisible``.
Ragged groups make blocks of unequal width; each is zero-padded to the
widest (``p_shard``), and the pad columns are inert:

* a block's local ``GroupSpec`` keeps the REAL sizes, starts, pad_index
  and pad_mask of its groups, so ``pad_groups`` and the kernels never read
  a pad column; only ``group_ids`` maps the pads, onto the last local
  group, whose segment sums take them as exact ``0.0`` terms
  (``groups.group_sum`` runs that group's segment over them);
* the pad columns of X are zero, so their statistics (``|c| = 0``,
  column norm 0) never pass a keep rule.

Executors
---------
``FeatureOps`` maps a per-block program over the blocks a process holds:

* **stacked** (``group=None``): one process holds all ``S`` blocks on its
  device.  ``fmap`` is a Python loop over them whose outputs are
  ``torch.stack``-ed (no ``torch.vmap``: the segment reductions and the
  kernels do not batch under it); ``fsum`` adds the partials in shard
  order.  It fires no collective.
* **distributed**: a ``torch.distributed`` process group of exactly ``S``
  ranks (``launch.mesh.make_feature_mesh``); rank ``s`` holds block ``s``
  only, and every stacked tensor has a leading axis of 1.

Sharded data is "local-stacked": X as a list of the local ``(N,
p_shard)`` blocks (each its own allocation, so a block's products do not
depend on where it sits), the local specs as a list, every other
per-feature or per-group tensor with a leading axis over the local blocks.

Collectives
-----------
Only the distributed executor fires them; each is counted under its name
in the module's tallies (``collective_counts()``; the caller resets them
with ``reset_collective_counts()``, as it does the kernels' launch
counts):

* ``all_reduce_sum``: ``fsum``'s sum of the ``(N,)`` or ``(K, N)`` partial
  fits across ranks on the device group (the reference's one psum; also
  the scalar norms of ``sharded_spectral_norm``);
* ``all_reduce_min``: ``cert_sgl``'s dual scaling ``s = min`` over the
  shards' Lemma-9 roots, a scalar;
* ``all_reduce_max``: ``cert_nn``'s ``max`` correlation, a scalar;
* ``all_gather``: ``gather``, the host view of a stacked result (keep
  masks, the setup correlation ``X^T y``, a segment's certified ``c_prev``),
  on a ``gloo`` group of the same ranks (NCCL carries no CPU tensor).

Min and max are exactly associative, and the stacked ``fsum`` adds in
shard order, so the stacked executor's float64 kept sets and betas match
the unsharded engine's to rounding of the block GEMMs; two ranks add
``a + b == b + a`` and match the stacked executor bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .sharding import divisible
from ..core.groups import GroupSpec


def effective_shards(n_units: int, requested: int) -> int:
    """Largest shard count <= ``requested`` dividing ``n_units`` (group
    count for SGL, feature count for the nonnegative Lasso), degrading
    exactly like ``sharding.divisible``; 1 when nothing > 1 divides."""
    req = int(requested)
    for c in range(min(req, int(n_units)), 1, -1):
        if divisible(int(n_units), {"feature": c}, "feature"):
            return c
    return 1


def shard_width_bound(p: int, n_units: int, n_shards: int,
                      max_size: int) -> int:
    """Upper bound on the padded block width ``p_shard`` from shape data
    alone: a block holds ``n_units // n_shards`` groups of at most
    ``max_size`` columns (exact for uniform groups)."""
    if n_shards <= 1:
        return int(p)
    g_sh = max(int(n_units) // int(n_shards), 1)
    return min(int(p), g_sh * int(max_size))


def _local_spec(spec_np: dict, g0: int, g1: int, col0: int, p_shard: int,
                n_max: int, uniform: bool, device) -> GroupSpec:
    """Local GroupSpec of the group block [g0, g1), re-based to column 0.

    Real sizes and starts (not extended over the pad columns) keep every
    padded per-group computation bitwise the global one; the pad columns
    get group id ``G_loc - 1`` (inert zeros, see the module docstring)."""
    G_loc = g1 - g0
    sizes = spec_np["sizes"][g0:g1]
    starts = spec_np["starts"][g0:g1] - col0
    width = int(sizes.sum())
    gid = np.full(p_shard, G_loc - 1, dtype=np.int64)
    gid[:width] = spec_np["group_ids"][col0:col0 + width] - g0
    pad_idx = starts[:, None] + np.arange(n_max)[None, :]
    pad_mask = np.arange(n_max)[None, :] < sizes[:, None]
    pad_idx = np.where(pad_mask, pad_idx, 0)
    return GroupSpec.from_arrays(
        sizes, starts, gid, spec_np["weights"][g0:g1], pad_idx, pad_mask,
        uniform=bool(uniform), device=device)


@dataclasses.dataclass(frozen=True)
class FeatureShardPlan:
    """Static description of one group-aligned column partition; the
    layout shuttles work on host numpy arrays."""
    requested: int
    n_shards: int
    p: int
    n_units: int              # groups (SGL) or features (nonnegative Lasso)
    p_shard: int              # padded per-block width (max real width)
    units_per_shard: int
    col_starts: np.ndarray    # (S,) first original column of each block
    widths: np.ndarray        # (S,) real column count of each block
    specs: Optional[list]     # S local GroupSpecs on the spec's device;
    #                           None for the nonnegative Lasso

    @property
    def col_mask(self) -> np.ndarray:
        """(S, p_shard) validity of each padded block slot."""
        return (np.arange(self.p_shard)[None, :]
                < np.asarray(self.widths)[:, None])

    def stack_columns(self, X: np.ndarray) -> np.ndarray:
        """(N, p) -> (S, N, p_shard), blocks zero-padded on the right."""
        X = np.asarray(X)
        out = np.zeros((self.n_shards, X.shape[0], self.p_shard), X.dtype)
        for s in range(self.n_shards):
            c0, w = int(self.col_starts[s]), int(self.widths[s])
            out[s, :, :w] = X[:, c0:c0 + w]
        return out

    def shard_features(self, v: np.ndarray) -> np.ndarray:
        """(..., p) -> (S, ..., p_shard) host scatter (pads zero)."""
        v = np.asarray(v)
        out = np.zeros((self.n_shards,) + v.shape[:-1] + (self.p_shard,),
                       v.dtype)
        for s in range(self.n_shards):
            c0, w = int(self.col_starts[s]), int(self.widths[s])
            out[s, ..., :w] = v[..., c0:c0 + w]
        return out

    def unshard_features(self, a) -> np.ndarray:
        """(S, ..., p_shard) -> (..., p) host gather dropping pads."""
        a = np.asarray(a)
        out = np.zeros(a.shape[1:-1] + (self.p,), a.dtype)
        for s in range(self.n_shards):
            c0, w = int(self.col_starts[s]), int(self.widths[s])
            out[..., c0:c0 + w] = a[s, ..., :w]
        return out

    def shard_groups(self, a) -> np.ndarray:
        """(..., G) -> (S, ..., G_shard): contiguous blocks, no padding
        (every shard owns exactly ``units_per_shard`` groups)."""
        a = np.asarray(a)
        g = self.units_per_shard
        return np.stack([a[..., s * g:(s + 1) * g]
                         for s in range(self.n_shards)])

    def unshard_groups(self, a) -> np.ndarray:
        """(S, ..., G_shard) -> (..., G)."""
        a = np.asarray(a)
        return np.concatenate([a[s] for s in range(self.n_shards)], axis=-1)


def plan_feature_shards(requested: int, p: int,
                        spec: Optional[GroupSpec] = None) -> FeatureShardPlan:
    """The group-aligned partition (or, with ``spec=None``, the
    singleton-column partition of the nonnegative Lasso), the shard count
    degraded by ``effective_shards``.  The local specs are built on
    ``spec``'s device."""
    n_units = int(spec.num_groups) if spec is not None else int(p)
    S = effective_shards(n_units, requested)
    if spec is None:
        w = p // S
        return FeatureShardPlan(
            requested=int(requested), n_shards=S, p=int(p), n_units=n_units,
            p_shard=w, units_per_shard=w,
            col_starts=np.arange(S, dtype=np.int64) * w,
            widths=np.full(S, w, dtype=np.int64), specs=None)
    G_sh = n_units // S
    spec_np = {k: getattr(spec, k).cpu().numpy()
               for k in ("sizes", "starts", "group_ids", "weights")}
    g_lo = np.arange(S, dtype=np.int64) * G_sh
    col_starts = spec_np["starts"][g_lo].astype(np.int64)
    widths = np.concatenate([col_starts[1:], [p]]) - col_starts
    p_shard = int(widths.max())
    specs = [_local_spec(spec_np, int(g_lo[s]), int(g_lo[s]) + G_sh,
                         int(col_starts[s]), p_shard, spec.max_size,
                         spec.uniform, spec.device)
             for s in range(S)]
    return FeatureShardPlan(
        requested=int(requested), n_shards=S, p=int(p), n_units=n_units,
        p_shard=p_shard, units_per_shard=G_sh, col_starts=col_starts,
        widths=widths, specs=specs)


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_reduce_sum", "all_reduce_min", "all_reduce_max",
               "all_gather")
_COUNTS = dict.fromkeys(COLLECTIVES, 0)


def collective_counts() -> dict:
    """The collectives fired in this process since the last reset."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        _COUNTS[name] = 0


def _stack(outs):
    """Per-block outputs (tensors, or tuples of tensors) -> the stacked
    output (a tensor, or a tuple of tensors)."""
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(leaf) for leaf in zip(*outs))
    return torch.stack(outs)


@dataclasses.dataclass(frozen=True, eq=False)
class FeatureOps:
    """Maps per-block programs over the blocks this process holds.

    ``group`` is a ``torch.distributed`` process group of exactly
    ``n_shards`` ranks (rank s holds block s), or ``None`` for the stacked
    executor.  ``host_group`` carries the host gathers: ``group`` itself
    when it is a ``gloo`` group, else a ``gloo`` group of the same ranks.
    It holds no state of a run: each path or CV call builds its own."""
    n_shards: int
    group: object = None
    host_group: object = None

    @property
    def shards(self) -> tuple:
        """The global indices of the blocks this process holds."""
        if self.group is None:
            return tuple(range(self.n_shards))
        import torch.distributed as dist
        return (dist.get_rank(self.group),)

    # -- layout: the local blocks from full tensors, the host view back ----
    def local(self, per_shard: list) -> list:
        """The local entries of an (S,) per-shard list (the local specs)."""
        return [per_shard[s] for s in self.shards]

    def blocks(self, fshard: FeatureShardPlan, X: torch.Tensor) -> list:
        """The local ``(N, p_shard)`` blocks of X, each its own contiguous
        tensor on X's device, zero-padded on the right."""
        out = []
        for s in self.shards:
            c0, w = int(fshard.col_starts[s]), int(fshard.widths[s])
            b = torch.zeros((X.shape[0], fshard.p_shard), dtype=X.dtype,
                            device=X.device)
            b[:, :w] = X[:, c0:c0 + w]
            out.append(b)
        return out

    def scatter(self, fshard: FeatureShardPlan, a: torch.Tensor):
        """(..., p) -> local-stacked (n_local, ..., p_shard), pads zero."""
        out = torch.zeros((len(self.shards),) + tuple(a.shape[:-1])
                          + (fshard.p_shard,), dtype=a.dtype, device=a.device)
        for i, s in enumerate(self.shards):
            c0, w = int(fshard.col_starts[s]), int(fshard.widths[s])
            out[i, ..., :w] = a[..., c0:c0 + w]
        return out

    def scatter_groups(self, fshard: FeatureShardPlan, a: torch.Tensor):
        """(..., G) -> local-stacked (n_local, ..., G_shard)."""
        g = fshard.units_per_shard
        return torch.stack([a[..., s * g:(s + 1) * g] for s in self.shards])

    def gather(self, a: torch.Tensor) -> np.ndarray:
        """Local-stacked (n_local, ...) -> the host view of all ``S``
        blocks, a numpy (S, ...) array: one ``all_gather`` across ranks."""
        t = a.detach().cpu()
        if self.group is None:
            return t.numpy()
        import torch.distributed as dist
        is_bool = t.dtype == torch.bool
        if is_bool:                     # gloo carries no bool tensor
            t = t.to(torch.uint8)
        parts = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(parts, t.contiguous(), group=self.host_group)
        _COUNTS["all_gather"] += 1
        out = torch.cat(parts).numpy()
        return out.astype(bool) if is_bool else out

    # -- mapping, and the reductions across blocks ---------------------------
    def fmap(self, body, sharded, *replicated):
        """``body(local, *replicated)`` for each local block; ``sharded`` is
        one local-stacked sequence or a tuple of them, and ``local`` the
        block's entry (entries).  The outputs are stacked over the blocks.
        Block-local: fires no collective."""
        outs = []
        for i in range(len(self.shards)):
            loc = (tuple(x[i] for x in sharded) if isinstance(sharded, tuple)
                   else sharded[i])
            outs.append(body(loc, *replicated))
        return _stack(outs)

    def _all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=red, group=self.group)
        _COUNTS[f"all_reduce_{op}"] += 1
        return t

    def fsum(self, body, sharded, *replicated):
        """Per-block partial results, summed over all ``S`` blocks: in
        shard order within a process, then ``all_reduce(SUM)`` across
        ranks (the reference's one psum)."""
        parts = self.fmap(body, sharded, *replicated)

        def total(x):
            acc = x[0].clone()
            for i in range(1, x.shape[0]):
                acc = acc + x[i]
            return acc if self.group is None else self._all_reduce(acc, "sum")

        if isinstance(parts, tuple):
            return tuple(total(x) for x in parts)
        return total(parts)

    def fmin(self, x: torch.Tensor) -> torch.Tensor:
        """Min over every entry of a local-stacked tensor, across ranks."""
        m = torch.min(x).reshape(1)
        return (m if self.group is None else self._all_reduce(m, "min"))[0]

    def fmax(self, x: torch.Tensor) -> torch.Tensor:
        """Max over every entry of a local-stacked tensor, across ranks."""
        m = torch.max(x).reshape(1)
        return (m if self.group is None else self._all_reduce(m, "max"))[0]


_HOST_GROUPS: dict = {}


def feature_ops(n_shards: int, group=None, host_group=None) -> FeatureOps:
    """The executor for ``n_shards`` blocks over ``group`` (``None``:
    stacked).  ``host_group`` carries the host gathers (a fold-feature
    mesh builds its own); without it, a group whose backend is not
    ``gloo`` gets a ``gloo`` group of the same ranks, built at its first
    use (a collective call that every rank makes at the same point) and
    kept for the group's later calls."""
    host = host_group
    if group is not None and host is None:
        import torch.distributed as dist
        if dist.get_backend(group) == "gloo":
            host = group
        else:
            host = _HOST_GROUPS.get(group)
            if host is None:
                host = _HOST_GROUPS[group] = dist.new_group(backend="gloo")
    return FeatureOps(int(n_shards), group, host)


def resolve_feature_mesh(n_shards: int):
    """The process group of ``n_shards`` ranks when ``torch.distributed``
    runs with exactly that many, else ``None`` (the stacked executor)."""
    if n_shards <= 1:
        return None
    from ..launch.mesh import make_feature_mesh
    return make_feature_mesh(n_shards)


# ---------------------------------------------------------------------------
# Sharded numerical primitives (each a thin composition of fmap / fsum).
# ``use_kernels`` runs the GEMV ``X_b^T v`` of every block through the
# ``xtv`` kernel (float32; its plain version on the CPU).
# ---------------------------------------------------------------------------

def sharded_xtv(ops: FeatureOps, Xs, v, use_kernels: bool = False):
    """Stacked correlations ``(n_local, p_shard)``: each block's ``X_b^T
    v``."""
    from ..core.screening import _xtv
    return ops.fmap(lambda Xb, vv: _xtv(Xb, vv, use_kernels).to(vv.dtype),
                    Xs, v)


def sharded_fit(ops: FeatureOps, Xs, v_s):
    """``X @ v`` from a stacked coefficient layout ``(n_local, p_shard)``
    (or ``(n_local, K, p_shard)``, giving ``(K, N)``): a partial GEMV per
    block and one sum across blocks; pad columns multiply zero
    coefficients."""
    def body(loc):
        Xb, vb = loc
        return vb @ Xb.T if vb.ndim > 1 else Xb @ vb
    return ops.fsum(body, (Xs, v_s))


def sharded_column_norms(ops: FeatureOps, Xs):
    from ..core.linalg import column_norms
    return ops.fmap(column_norms, Xs)


def sharded_group_spectral_norms(ops: FeatureOps, Xs, specs,
                                 iters: int = 30):
    """``(n_local, G_shard)`` ``||X_g||_2`` from each block and its local
    spec (``specs``: the local specs)."""
    from ..core.linalg import group_spectral_norms
    return ops.fmap(lambda loc: group_spectral_norms(loc[0], loc[1],
                                                     iters=iters),
                    (Xs, specs))


def sharded_group_frobenius_norms(ops: FeatureOps, Xs, specs):
    from ..core.linalg import group_frobenius_norms
    return ops.fmap(lambda loc: group_frobenius_norms(loc[0], loc[1]),
                    (Xs, specs))


def sharded_spectral_norm(ops: FeatureOps, fshard: FeatureShardPlan, Xs,
                          iters: int = 50, seed: int = 0) -> torch.Tensor:
    """``||X||_2`` by power iteration over the sharded columns, from
    ``linalg.spectral_norm``'s numpy start vector (scattered to the
    blocks, pads zero).  Each step sums the N-vector ``u = sum_b X_b v_b``
    and the squared norm of the back-projection across blocks; pad slots
    stay exactly zero."""
    X0 = Xs[0]
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        fshard.p), dtype=X0.dtype, device=X0.device)
    v_s = ops.scatter(fshard, v)

    def normalize(w_s):
        nrm = torch.sqrt(ops.fsum(lambda w: torch.sum(w * w), w_s))
        return w_s / torch.clamp(nrm, min=1e-30)

    v_s = normalize(v_s)
    for _ in range(iters):
        u = sharded_fit(ops, Xs, v_s)
        v_s = normalize(ops.fmap(lambda Xb, uu: Xb.T @ uu, Xs, u))
    return torch.linalg.vector_norm(sharded_fit(ops, Xs, v_s))


def cert_sgl(ops: FeatureOps, Xs, specs, rho, alpha,
             use_kernels: bool = False):
    """Sharded SGL certification: the stacked ``c = X^T rho`` and the
    dual scaling ``s = min_g 1/rho_g`` (``dual_scaling_sgl``).  The
    per-group shrink roots are block-local; the min runs over every block
    (across ranks, ``all_reduce(MIN)``), and min is exactly associative,
    so ``s`` equals the unsharded value for the same ``c``."""
    from ..core.lambda_max import group_shrink_roots
    from ..core.screening import _xtv

    def body(loc, rho):
        Xb, spec_loc = loc
        c = _xtv(Xb, rho, use_kernels).to(rho.dtype)
        roots = group_shrink_roots(spec_loc, c, alpha)
        return c, torch.where(roots > 1.0, 1.0 / roots, 1.0)

    c_s, scale_s = ops.fmap(body, (Xs, specs), rho)
    return c_s, ops.fmin(scale_s)


def cert_nn(ops: FeatureOps, Xs, rho, use_kernels: bool = False):
    """Sharded nonnegative-Lasso certification (``dual_scaling_nn``): pad
    columns give ``c = 0``, which never lifts the max above 1, so ``s``
    equals the unsharded value (across ranks, ``all_reduce(MAX)``)."""
    c_s = sharded_xtv(ops, Xs, rho, use_kernels)
    m = ops.fmax(c_s)
    return c_s, torch.where(m > 1.0, 1.0 / m, torch.ones_like(m))
