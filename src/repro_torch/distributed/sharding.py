"""Sharding rules of the LM zoo and the collectives that realise them on
``torch.distributed`` ranks (PyTorch port of ``repro.distributed.sharding``).

The rules are the reference's, rule for rule: parameters (ZeRO-3 over the
data axes and the tensor-parallel dims over 'model', ``models.model.
param_pspecs``), batches over the data axes (``batch_pspec``) and caches
over data, model or the sequence (``cache_pspecs``).  Every rule degrades:
a dim is sharded only when the axes' size exceeds 1 and divides it
(``divisible``), so the same code runs on (16, 16), (2, 16, 16) and a mesh
of one.

Where the reference's single controller lets XLA place global arrays, each
rank here holds its block of every sharded leaf and computes on its rows
of the batch, and these functions keep the reference's global values:

* ``named(mesh, specs)``: a tree of ``NamedSharding``, whose ``local``
  takes this rank's block of a full array and ``gather`` undoes it.
* ``gather_params``: the blocks gathered for use inside the loss, through
  ``_Gather``: its backward sums the gradient over the batch axes and keeps
  the rank's block (a reduce-scatter), and over 'model' keeps the block
  without a sum (compute is replicated along 'model').  Expert dims stay
  local (expert parallelism).  ``reduce_grads`` sums the gradient of a
  leaf over the batch axes its spec does not name.
* ``global_sq_norm``: the squared norm of a sharded gradient tree, each
  block counted once.
* ``local_rows``: the rank's rows of a global batch, or a mesh view whose
  ranks each hold the whole batch (``LMMesh.batch_replicated``).
* ``split_seq`` / ``gather_seq``: ``seq_shard``'s residual stream, S /
  |model| rows a rank between layers.
* ``copy_to_group`` / ``reduce_from_group``: expert parallelism's entry
  (backward: a sum over 'model') and combine (forward: a sum over 'model',
  backward the identity).

Tensor-parallel serving (the reference's ``tp_only`` dry-run layout) is
the exception to gathering: ``serving_pspecs`` splits the parameters over
'model' by the rules and replicates them over the data axes, each rank
keeps its blocks, and the forward steps run on them between two
forward-only boundary ops: ``tp_reduce`` (the partial sums of a
row-parallel product, or of a vocab-parallel lookup, summed over 'model')
and ``tp_gather`` (vocab-split logits joined along the vocabulary).

Collectives are counted (``collective_counts``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.common import (CONSTRAINTS, DEFAULT_RULES, P, is_desc, is_spec,
                             tree_specs)
from ..pytree import flatten, leaves, plain_structure, tree_map, unflatten


def mesh_shape_dict(mesh) -> dict:
    return dict(mesh.shape)


def dp_axes(mesh_shape: Mapping[str, int]):
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def divisible(n, mesh_shape, axes) -> bool:
    """A dim of size ``n`` shards over ``axes`` only when their combined
    size exceeds 1 AND divides ``n`` evenly; otherwise the layout degrades
    to replicated.  ``mesh_shape`` maps axis names to sizes."""
    if isinstance(axes, str):
        axes = (axes,)
    size = int(np.prod([mesh_shape.get(a, 1) for a in axes]))
    return size > 1 and n % size == 0


_div = divisible


def batch_pspec(cfg, shape_name, mesh_shape, batch_size: int):
    """Shardings for the input batch dict."""
    dp = dp_axes(mesh_shape)
    bdim = dp if _div(batch_size, mesh_shape, dp) else None
    return {
        "tokens": P(bdim, None),
        "labels": P(bdim, None),
        "patches": P(bdim, None, None),
        "frames": P(bdim, None, None),
    }


def serving_pspecs(cfg, mesh_shape):
    """The parameters' ``P`` tree under the serving layout on a mesh of
    ``mesh_shape`` (the reference dry run's ``tp_only`` specs):
    ``DEFAULT_RULES`` with 'embed' unsplit, so the parameters are whole
    over the data axes, split over 'model' only, and a forward step
    gathers none of them."""
    from ..models.model import param_descs
    return tree_specs(param_descs(cfg), mesh_shape,
                      dict(DEFAULT_RULES, embed=()))


def _kv_cache_pspec(mesh_shape, batch, seq, kv_heads):
    dp = dp_axes(mesh_shape)
    if _div(batch, mesh_shape, dp):
        b, s = dp, None
    elif _div(seq, mesh_shape, dp):
        b, s = None, dp            # sequence-parallel cache (long context)
    else:
        b = s = None
    h = "model" if _div(kv_heads, mesh_shape, "model") else None
    if h is None and s is None and _div(seq, mesh_shape, "model"):
        s = "model"                # fall back: the sequence over 'model'
    return P(b, s, h, None)


def cache_pspecs(cfg, batch: int, cache_len: int, mesh_shape):
    """The ``P`` tree matching ``models.model.cache_shapes``."""
    from ..models.attention import KVCache, MLACache
    from ..models.ssm import MambaCache
    from ..models.xlstm import MLSTMCache, SLSTMCache
    dp = dp_axes(mesh_shape)
    bdim = dp if _div(batch, mesh_shape, dp) else None
    md = lambda n: "model" if _div(n, mesh_shape, "model") else None
    d_in = cfg.ssm_expand * cfg.d_model
    H_ssm = d_in // cfg.ssm_head_dim
    H_x = cfg.num_heads

    def kind_spec(kind):
        if kind in ("attn", "global", "dense_ffn_attn", "moe", "local",
                    "shared"):
            if cfg.mla and kind != "shared":
                seq_ax = None
                if bdim is None and _div(cache_len, mesh_shape, dp):
                    seq_ax = dp
                return MLACache(P(bdim, seq_ax, None), P(bdim, seq_ax, None))
            seq = cfg.window_size if kind == "local" else cache_len
            return KVCache(
                _kv_cache_pspec(mesh_shape, batch, seq, cfg.num_kv_heads),
                _kv_cache_pspec(mesh_shape, batch, seq, cfg.num_kv_heads))
        if kind == "mamba":
            conv_dim = d_in + 2 * cfg.ssm_state
            return MambaCache(P(bdim, None, md(conv_dim)),
                              P(bdim, md(H_ssm), None, None))
        if kind == "mlstm":
            return MLSTMCache(P(bdim, md(H_x), None, None),
                              P(bdim, md(H_x), None),
                              P(bdim, md(H_x)),
                              P(bdim, None, md(2 * cfg.d_model)))
        if kind == "slstm":
            s = P(bdim, md(H_x), None)
            return SLSTMCache(s, s, s, s)
        raise ValueError(kind)

    def pattern_entry(kind):
        if kind == "mamba":
            return {"mamba": kind_spec("mamba")}
        if kind == "mamba+shared_attn":
            return {"mamba": kind_spec("mamba"), "shared": kind_spec("shared")}
        return kind_spec(kind)

    stack = lambda tree: tree_map(lambda s: P(None, *s), tree,
                                  is_leaf=is_spec)
    if cfg.family == "encdec":
        seq_ax = None
        if bdim is None and _div(cache_len, mesh_shape, dp):
            seq_ax = dp
        return {"decoder": stack({"self": kind_spec("shared")}),
                "enc_out": P(bdim, seq_ax, None)}
    period = {f"l{i}": pattern_entry(kind)
              for i, kind in enumerate(cfg.block_pattern)}
    return {"blocks": stack(period),
            "prologue": [pattern_entry(kind) for kind in cfg.prologue]}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

TALLIES = ("all_gather", "reduce_scatter", "all_reduce")
_COUNTS = dict.fromkeys(TALLIES, 0)


def collective_counts() -> dict:
    """Collectives run in this process since the last reset, by kind
    (each a call on one group)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for name in TALLIES:
        _COUNTS[name] = 0


def constrain_counts() -> dict:
    """``models.common.constrain``'s calls since the last reset, by the
    resolved spec (a tuple)."""
    return {tuple(k): v for k, v in CONSTRAINTS.items()}


def reset_constrain_counts() -> None:
    CONSTRAINTS.clear()


def _dist():
    import torch.distributed as dist
    return dist


def all_reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks along ``axes`` (a new tensor;
    ``t`` itself when the group holds one rank)."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return t
    out = t.detach().clone()
    _dist().all_reduce(out, group=group)
    _COUNTS["all_reduce"] += 1
    return out


def tp_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The partial sums ``t`` of this rank's blocks summed over 'model'
    (forward only: serving runs without autograd)."""
    return all_reduce_sum(t.contiguous(), mesh, "model")


def tp_gather(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The 'model' ranks' blocks of ``t`` joined along ``dim`` in block
    order (forward only)."""
    return _all_gather_dim(t, dim, mesh, "model")


def _gather_list(t: torch.Tensor, group, n: int) -> list:
    """Every member's ``t`` in the group's rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _dist().all_gather(parts, t, group=group)
    _COUNTS["all_gather"] += 1
    return parts


def _all_gather_dim(t, dim, mesh, axes) -> torch.Tensor:
    """The blocks of ``t`` along ``axes`` concatenated along ``dim`` in
    block order."""
    n = mesh.axes_size(axes)
    parts = _gather_list(t, mesh.group(axes), n)
    ordered = [None] * n
    for part, b in zip(parts, mesh.group_blocks(axes)):
        ordered[b] = part
    return torch.cat(ordered, dim)


def _block(t, dim, mesh, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a contiguous copy)."""
    n = mesh.axes_size(axes)
    blk = t.shape[dim] // n
    return t.narrow(dim, mesh.block_index(axes) * blk, blk).contiguous()


def _reduce_scatter_dim(t, dim, mesh, axes) -> torch.Tensor:
    """``t`` summed over the group of ``axes``; this rank's block along
    ``dim``."""
    chunks = t.chunk(mesh.axes_size(axes), dim)
    ins = [chunks[b].contiguous() for b in mesh.group_blocks(axes)]
    out = torch.empty_like(ins[0])
    _dist().reduce_scatter(out, ins, group=mesh.group(axes))
    _COUNTS["reduce_scatter"] += 1
    return out


class _Gather(torch.autograd.Function):
    """Forward: this rank's block gathered along ``dim`` over ``axes``.
    Backward: the gradient summed over the group and cut to the block
    (``reduce``: the batch axes, whose ranks see other rows), or cut to the
    block alone ('model', whose ranks compute the same values)."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axes, reduce):
        ctx.args = (dim, mesh, axes, reduce)
        return _all_gather_dim(t, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, reduce = ctx.args
        out = (_reduce_scatter_dim(g, dim, mesh, axes) if reduce
               else _block(g, dim, mesh, axes))
        return out, None, None, None, None


class _Split(torch.autograd.Function):
    """Forward: this rank's block along ``dim`` over ``axes``.  Backward:
    the blocks' gradients gathered (each rank's downstream is replicated,
    so every rank then holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _block(t, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes = ctx.args
        return _all_gather_dim(g, dim, mesh, axes), None, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    group (each rank's branch after it saw part of the work)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce_sum(g.contiguous(), mesh, axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Forward: the partial values summed over the group.  Backward: the
    identity (the downstream is replicated over the group)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce_sum(t.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _entry_axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def effective_spec(spec) -> P:
    """The layout a rank's block follows: ``spec`` with every entry that
    names an axis an earlier entry already split replaced by ``None``.
    (The reference's rules can name 'model' twice, on an mLSTM projection's
    'mlp' and 'heads' dims at |model| = 2, which a JAX sharding refuses;
    the port splits the first of the two.)"""
    used, out = set(), []
    for e in spec:
        axes = () if e is None else _entry_axes(e)
        if used.intersection(axes):
            out.append(None)
            continue
        used.update(axes)
        out.append(e)
    return P(*out)


def _is_batch_entry(entry) -> bool:
    return all(a in ("pod", "data") for a in _entry_axes(entry))


def gather_leaf(block, spec, mesh, keep_local=()):
    """The full leaf from this rank's ``block`` (autograd through
    ``_Gather``); dims listed in ``keep_local`` stay this rank's block.
    Gathers the batch-axis entries first."""
    t = block
    spec = effective_spec(spec)
    order = sorted((i for i, e in enumerate(spec) if e is not None
                    and i not in keep_local
                    and mesh.axes_size(_entry_axes(e)) > 1),
                   key=lambda i: not _is_batch_entry(spec[i]))
    for i in order:
        t = _Gather.apply(t, i, mesh, _entry_axes(spec[i]),
                          _is_batch_entry(spec[i]))
    return t


def expert_dims(desc, spec) -> tuple:
    """Dims of a leaf that expert parallelism keeps local: its 'experts'
    dim when the spec splits it over 'model'."""
    return tuple(i for i, (ax, e) in enumerate(zip(desc.axes, spec))
                 if ax == "experts" and e == "model")


def gather_params(params, specs, descs, mesh):
    """A plain dict tree of the full leaves, gathered from the blocks of
    ``params`` (a ``ParamTree`` or dict; autograd reaches the blocks); a
    leaf no spec entry splits is returned as it is."""
    flat, td = flatten(params)
    flat_s = leaves(specs, is_leaf=is_spec)
    flat_d = leaves(descs, is_leaf=is_desc)
    out = [gather_leaf(b, s, mesh, expert_dims(d, s))
           for b, s, d in zip(flat, flat_s, flat_d)]
    return unflatten(plain_structure(td), out)


def reduce_grads(grads: list, specs, mesh) -> list:
    """Each gradient summed over the batch axes its spec does not name
    (those the gathers' backward has not summed), in place."""
    flat_s = leaves(specs, is_leaf=is_spec)
    dp = dp_axes(mesh.shape)
    for g, s in zip(grads, flat_s):
        named = {a for e in s if e is not None for a in _entry_axes(e)}
        missing = tuple(a for a in dp if a not in named)
        if missing and mesh.group(missing) is not None:
            _dist().all_reduce(g, group=mesh.group(missing))
            _COUNTS["all_reduce"] += 1
    return grads


def global_sq_norm(grads: list, specs, mesh) -> torch.Tensor:
    """The squared norm of the full gradient tree in float32: the blocks'
    squares summed over the axes that split each leaf, so each element is
    counted once (a leaf replicated along an axis is not summed over
    it)."""
    flat_s = [effective_spec(s) for s in leaves(specs, is_leaf=is_spec)]
    by_axes: dict = {}
    for g, s in zip(grads, flat_s):
        axes = tuple(a for a in mesh.axis_names
                     if any(e is not None and a in _entry_axes(e) for e in s)
                     and mesh.shape[a] > 1)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes in sorted(by_axes, key=lambda a: (len(a), a)):
        part = (all_reduce_sum(by_axes[axes], mesh, axes) if axes
                else by_axes[axes])
        total = part if total is None else total + part
    return total


def local_rows(batch: dict, mesh):
    """(this rank's rows of the global ``batch``, the mesh to compute
    them under).  Rows are the contiguous block of ``batch_pspec``: when
    the batch axes do not divide the batch, every rank keeps it whole and
    the mesh comes back as its ``replicated_batch()`` view."""
    B = next(iter(batch.values())).shape[0]
    dp = dp_axes(mesh.shape)
    if mesh.batch_replicated or not _div(B, mesh.shape, dp):
        return batch, (mesh if mesh.batch_replicated
                       else mesh.replicated_batch())
    return {k: _block(v, 0, mesh, dp) for k, v in batch.items()}, mesh


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` (dim 0) in batch order: the inverse of
    ``local_rows``."""
    dp = dp_axes(mesh.shape)
    if mesh.batch_replicated or mesh.group(dp) is None:
        return t
    return _all_gather_dim(t, 0, mesh, dp)


def split_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """This 'model' rank's rows of the sequence (dim 1)."""
    return _Split.apply(x, 1, mesh, ("model",))


def gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence from the 'model' ranks' rows; the gradient keeps
    this rank's rows, without a sum."""
    return _Gather.apply(x, 1, mesh, ("model",), False)


def copy_to_group(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _CopyTo.apply(t, mesh, axes)


def reduce_from_group(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _ReduceFrom.apply(t, mesh, axes)


# ---------------------------------------------------------------------------
# named shardings
# ---------------------------------------------------------------------------

class NamedSharding:
    """A spec on a mesh: ``local(full)`` is this rank's block of a full
    array (a tensor or a numpy array; a copy when any dim is split, the
    array itself otherwise), ``gather(block)`` every rank's blocks joined
    back into the full array (a collective: every rank calls it)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def _splits(self, ndim):
        for i, e in enumerate(tuple(effective_spec(self.spec))[:ndim]):
            if e is not None and self.mesh.axes_size(_entry_axes(e)) > 1:
                yield i, _entry_axes(e)

    def local_shape(self, shape) -> tuple:
        out = list(shape)
        for i, axes in self._splits(len(shape)):
            out[i] //= self.mesh.axes_size(axes)
        return tuple(out)

    def local(self, full):
        idx = [slice(None)] * full.ndim
        for i, axes in self._splits(full.ndim):
            n = self.mesh.axes_size(axes)
            if full.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(full.shape)} does not "
                                 f"split over {axes} ({n} ranks)")
            blk = full.shape[i] // n
            b = self.mesh.block_index(axes)
            idx[i] = slice(b * blk, (b + 1) * blk)
        if all(s == slice(None) for s in idx):
            return full
        out = full[tuple(idx)]
        return out.clone() if isinstance(out, torch.Tensor) \
            else np.array(out)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        t = block
        for i, axes in self._splits(block.ndim):
            t = _all_gather_dim(t, i, self.mesh, axes)
        return t

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named(mesh, spec_tree):
    """A tree of ``NamedSharding(mesh, spec)``, one a ``P`` leaf."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=is_spec)


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)
