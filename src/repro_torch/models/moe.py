"""Token-choice top-k MoE with expert parallelism (PyTorch port of
``repro.models.moe``).

Dispatch is the reference's: token-expert pairs are sorted by expert
(stably, so within an expert they stay in token order), each expert takes
one fixed ``capacity`` window of the sorted pairs (the pair arrays padded by
``capacity`` so no window runs off the end), and pairs past an expert's
capacity are dropped.  All windows are gathered at once into an
``(E, capacity, d)`` stack and the experts' FFNs run as batched matmuls, so
no count is read on the host.  The combine gathers each token's k expert
outputs back and adds them into a ``(T, d)`` accumulator in increasing
expert order, the order in which the reference's expert loop scatter-adds
them, in the input's dtype.  A gather instead of a scatter-add keeps the
sum free of atomics: two calls on the card give the same bits.

Under an ``LMMesh`` (each rank holding its rows of the batch) three paths
keep the reference's values:

* expert parallelism, when |model| > 1 divides E (the reference's
  ``shard_map``): each 'model' rank holds E / |model| experts, dispatches
  its data block's tokens at the reference's per-shard capacity
  ``max(min(ceil(T_local k / |model| cf), T_local k), 8)`` and the partial
  outputs are summed over 'model' (backward: the identity; the tokens and
  gate weights enter through a sum of their gradients over 'model');
* otherwise, with the rows split over the data axes, the reference's
  dispatch of the global batch: a pair is kept when its place among its
  expert's pairs in global order is below the global capacity, each rank
  learning the pairs before its own from one all-reduce of the per-expert
  counts;
* the batch held whole on every rank: the path without a mesh.

The load-balancing auxiliary uses the global token count and expert
fractions (one all-reduce), so the ranks' values sum to the reference's.
``log_kept`` records the pairs each dispatch keeps.

Under tensor-parallel serving (``ExpertSplit``: the rank holds its blocks
by the serving specs) the routed experts run expert-parallel as above, and
the shared experts' channels are split over 'model' too (``shared_in`` /
``shared_gate`` column-parallel, ``shared_out`` row-parallel): the rank's
shared partial is added to its routed partial before the one all-reduce
over 'model', where the reference adds the whole shared output after its
``psum`` (the same sum in another order).  The auxiliary is then the
rank's own rows' (serving reads none), so no other collective runs.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..distributed import sharding as sh
from .common import ParamDesc, activation, is_glu


def moe_descs(cfg):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    descs = {
        "router": ParamDesc((d, E), ("embed", None)),
        "w_in": ParamDesc((E, d, f), ("experts", "embed", None)),
        "w_out": ParamDesc((E, f, d), ("experts", None, "embed")),
    }
    if is_glu(cfg.mlp_act):
        descs["w_gate"] = ParamDesc((E, d, f), ("experts", "embed", None))
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        descs["shared_in"] = ParamDesc((d, fs), ("embed", "mlp"))
        descs["shared_out"] = ParamDesc((fs, d), ("mlp", "embed"))
        if is_glu(cfg.mlp_act):
            descs["shared_gate"] = ParamDesc((d, fs), ("embed", "mlp"))
    return descs


def router_topk(p, x, cfg, mesh=None):
    """Returns (expert_idx (B, S, k) int64, gate_w (B, S, k) float32, aux
    scalar).  Ties in the top k go to the lower expert index, as in
    ``jax.lax.top_k``: a stable descending sort, cut to k.  With ``mesh``
    (rows split over its batch axes) aux is this rank's share: ``E
    sum_e (sum of its probs_e) ce_e / T`` with the global token count T
    and expert fractions ce."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    gate_w, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_w, expert_idx = gate_w[..., :k], expert_idx[..., :k]
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    # switch-style load-balancing auxiliary
    E = cfg.num_experts
    me = torch.mean(probs.reshape(-1, E), dim=0)
    # F.one_hot checks its input on the host; a comparison does not
    one_hot = (expert_idx[..., None] == torch.arange(
        E, device=x.device)).to(torch.float32)
    if mesh is not None:
        counts = torch.sum(one_hot, dim=-2).reshape(-1, E)
        glob = sh.all_reduce_sum(torch.cat([
            counts.sum(0), counts.new_full((1,), counts.shape[0])]),
            mesh, sh.dp_axes(mesh.shape))
        ce = glob[:E] / glob[E] / k
        aux = E * torch.sum(probs.reshape(-1, E).sum(0) * ce) / glob[E]
        return expert_idx, gate_w, aux
    ce = torch.mean(torch.sum(one_hot, dim=-2).reshape(-1, E), dim=0) / k
    aux = E * torch.sum(me * ce)
    return expert_idx, gate_w, aux


def _matmul(a, b):
    """``a @ b`` in the promoted dtype (jnp promotes; torch refuses)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _expert_ffn(tokens, w_in, w_gate, w_out, act):
    """tokens: (..., C, d) for each expert of the leading axes."""
    h = _matmul(tokens, w_in)
    if w_gate is not None:
        h = activation(act, h, _matmul(tokens, w_gate))
    else:
        h = activation(act, h)
    return _matmul(h, w_out)


_KEPT = []          # the lists ``log_kept`` fills


@contextlib.contextmanager
def log_kept():
    """Yields a list that receives, for each ``moe_ffn_local`` call inside
    the block, the number of pairs it kept (a 0-dim tensor on its device;
    one sum a call, nothing read on the host)."""
    out = []
    _KEPT.append(out)
    try:
        yield out
    finally:
        _KEPT.remove(out)


def moe_ffn_local(x_flat, expert_idx, gate_w, w_in, w_gate, w_out, *,
                  e_lo, n_local, capacity, act, limit=None):
    """MoE contribution of experts [e_lo, e_lo + n_local) to local tokens.

    x_flat: (T, d); expert_idx / gate_w: (T, k).  Returns (T, d) in
    x_flat's dtype; pairs routed to other experts contribute nothing.
    ``limit`` (n_local,): keep only each expert's first ``limit[e]`` pairs
    as well (at most ``capacity``)."""
    T, d = x_flat.shape
    k = expert_idx.shape[1]
    dev = x_flat.device
    pair_tok = torch.arange(T, device=dev).repeat_interleave(k)   # (T*k,)
    pair_exp = expert_idx.reshape(-1) - e_lo
    pair_w = gate_w.reshape(-1)
    local = (pair_exp >= 0) & (pair_exp < n_local)
    sort_key = torch.where(local, pair_exp, torch.full_like(pair_exp,
                                                            n_local))
    pair_exp_s, order = torch.sort(sort_key, stable=True)
    # each expert's run of the sorted pairs (bincount would read its size
    # on the host)
    starts = torch.searchsorted(pair_exp_s, torch.arange(n_local,
                                                         device=dev))
    # pad by `capacity` so every window lies inside the array
    pair_tok_s = torch.cat([pair_tok[order], pair_tok.new_zeros(capacity)])

    slot = torch.arange(capacity, device=dev)
    window = starts[:, None] + slot[None, :]                # (E, C)
    idx = pair_tok_s[window]
    rows = x_flat[idx]                                      # (E, C, d)
    out = _expert_ffn(rows, w_in, w_gate, w_out, act)       # (E, C, d)
    # a kept pair's slot in its expert's window; the rest are dropped
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * k, device=dev)
    e_safe = torch.clamp(pair_exp, 0, n_local - 1)
    rank = rank - starts[e_safe]
    kept = local & (rank < capacity)
    if limit is not None:
        kept = kept & (rank < limit[e_safe])
    for log in _KEPT:
        log.append(kept.sum())
    flat = e_safe * capacity + torch.clamp(rank, max=capacity - 1)
    wts = torch.where(kept, pair_w, torch.zeros_like(pair_w))
    contrib = out.reshape(n_local * capacity, -1)[flat]      # (T*k, d)
    contrib = (contrib * wts[:, None].to(contrib.dtype)).reshape(T, k, d)
    # each token's experts in increasing order, as the expert loop adds them
    by_expert = torch.argsort(torch.where(kept, pair_exp, n_local)
                              .reshape(T, k), dim=1, stable=True)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(T, k, d))
    acc = torch.zeros((T, d), dtype=x_flat.dtype, device=dev)
    for j in range(k):
        acc = acc + contrib[:, j].to(x_flat.dtype)
    return acc


def capacity_of(T: int, k: int, E: int, capacity_factor) -> int:
    """The single-shard capacity: every pair when ``capacity_factor`` is
    None (lossless, for decode), else ``ceil(T k / E * factor)`` capped at
    T k, and at least 8."""
    if capacity_factor is None:
        return T * k
    return max(min(int(np.ceil(T * k / E * capacity_factor)), T * k), 8)


class ExpertSplit(NamedTuple):
    """A MoE layer's layout on one 'model' rank of tensor-parallel
    serving: ``shared``, whether its spec splits the shared experts'
    channels (``shared_out`` (fs, d)) over 'model'.  The routed experts
    split wherever |model| divides E, as under expert parallelism."""
    shared: bool

    @classmethod
    def of(cls, specs) -> "ExpertSplit":
        """From the layer's FFN spec tree."""
        return cls("shared_out" in specs
                   and specs["shared_out"][0] == "model")


def shared_ffn(p, x, act):
    """The shared experts' FFN (this rank's channels of it under
    tensor-parallel serving, a partial sum)."""
    h = x @ p["shared_in"].to(x.dtype)
    if is_glu(act):
        h = activation(act, h, x @ p["shared_gate"].to(x.dtype))
    else:
        h = activation(act, h)
    return h @ p["shared_out"].to(x.dtype)


def shard_capacity(T: int, k: int, n_model: int, capacity_factor) -> int:
    """The per-shard capacity of expert parallelism over a 'model' axis of
    ``n_model`` for ``T`` local tokens (the reference's ``cap_of``): every
    pair when ``capacity_factor`` is None, else ``ceil(T k / n_model *
    factor)`` capped at T k, and at least 8."""
    if capacity_factor is None:
        return T * k
    return max(min(int(np.ceil(T * k / n_model * capacity_factor)), T * k),
               8)


def moe_forward(p, x, cfg, *, mesh=None, capacity_factor: float = 1.25,
                tp: Optional[ExpertSplit] = None):
    """x: (B, S, d), this rank's rows under a mesh -> ((B, S, d), aux
    loss).  ``capacity_factor=None`` is lossless dispatch (decode).  Under
    expert parallelism ``w_in`` / ``w_gate`` / ``w_out`` may hold every
    expert (the rank's are taken) or the rank's E / |model|.  ``tp``:
    tensor-parallel serving on ``mesh`` (``p`` holds the rank's blocks):
    the split parts' partial sums go through one all-reduce over 'model',
    and aux is the rank's rows' own.  Forward only."""
    from .model import check_mesh
    check_mesh(mesh)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    act = cfg.mlp_act
    Tl = B * S
    n_model = mesh.shape.get("model", 1) if mesh is not None else 1
    dp = sh.dp_axes(mesh.shape) if mesh is not None else ()
    split_rows = (mesh is not None and not mesh.batch_replicated
                  and mesh.group(dp) is not None)
    ep = n_model > 1 and E % n_model == 0
    expert_idx, gate_w, aux = router_topk(
        p, x, cfg, mesh if split_rows and tp is None else None)
    w_gate = p["w_gate"] if "w_gate" in p else None

    if ep:
        out = _expert_parallel(p, x, expert_idx, gate_w, w_gate, cfg, mesh,
                               capacity_factor, reduce=tp is None)
    elif split_rows and (tp is None or capacity_factor is not None):
        out = _global_dispatch(p, x, expert_idx, gate_w, w_gate, cfg, mesh,
                               capacity_factor)
    else:   # a lossless dispatch under tp needs only the rank's own rows
        out = moe_ffn_local(
            x.reshape(Tl, d), expert_idx.reshape(Tl, k),
            gate_w.reshape(Tl, k), p["w_in"], w_gate, p["w_out"], e_lo=0,
            n_local=E, capacity=capacity_of(Tl, k, E, capacity_factor),
            act=act).reshape(B, S, d)

    shared = shared_ffn(p, x, act) if cfg.num_shared_experts else None
    if tp is not None and shared is not None and tp.shared:
        # the rank's shared partial joins the routed one's all-reduce
        out = (sh.tp_reduce(out + shared, mesh) if ep
               else out + sh.tp_reduce(shared, mesh))
    else:
        if tp is not None and ep:
            out = sh.tp_reduce(out, mesh)
        if shared is not None:
            out = out + shared
    return out.to(x.dtype), aux


def _expert_parallel(p, x, expert_idx, gate_w, w_gate, cfg, mesh,
                     capacity_factor, reduce=True):
    """The 'model' rank's experts over its data block's tokens, the partial
    outputs summed over 'model' (the reference's ``shard_map`` body;
    ``reduce=False``: the rank's partial, in ``x``'s dtype)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    n_model = mesh.shape["model"]
    n_local = E // n_model
    dp = sh.dp_axes(mesh.shape)
    if (mesh.batch_replicated and mesh.group(dp) is not None
            and capacity_factor is not None):
        raise ValueError(
            f"expert parallelism splits the batch over {dp}: a batch they "
            f"do not divide has no per-shard capacity (the reference's "
            f"shard_map refuses it too)")
    mi = mesh.coords["model"]
    experts = lambda w: w if w is None or w.shape[0] == n_local \
        else w[mi * n_local:(mi + 1) * n_local]
    Tl = B * S
    cap = shard_capacity(Tl, k, n_model, capacity_factor)
    xe = sh.copy_to_group(x, mesh, ("model",))
    we = sh.copy_to_group(gate_w, mesh, ("model",))
    out = moe_ffn_local(
        xe.reshape(Tl, d), expert_idx.reshape(Tl, k), we.reshape(Tl, k),
        experts(p["w_in"]), experts(w_gate), experts(p["w_out"]),
        e_lo=mi * n_local, n_local=n_local, capacity=cap,
        act=cfg.mlp_act).to(x.dtype)
    if reduce:
        out = sh.reduce_from_group(out, mesh, ("model",))
    return out.reshape(B, S, d)


def _global_dispatch(p, x, expert_idx, gate_w, w_gate, cfg, mesh,
                     capacity_factor):
    """The single-shard path over the global batch, run on this rank's
    rows: the pairs of the ranks before it come first in each expert's
    window, so this rank keeps its first ``capacity - before`` pairs of
    each expert."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dp = sh.dp_axes(mesh.shape)
    n_dp, r = mesh.axes_size(dp), mesh.block_index(dp)
    Tl = B * S
    cap = capacity_of(Tl * n_dp, k, E, capacity_factor)
    counts = torch.zeros((n_dp, E), dtype=torch.int64, device=x.device)
    counts[r] = (expert_idx.reshape(-1, 1) == torch.arange(
        E, device=x.device)).sum(0)
    counts = sh.all_reduce_sum(counts, mesh, dp)
    before = counts[:r].sum(0)
    limit = torch.clamp(cap - before, min=0)
    return moe_ffn_local(
        x.reshape(Tl, d), expert_idx.reshape(Tl, k), gate_w.reshape(Tl, k),
        p["w_in"], w_gate, p["w_out"], e_lo=0, n_local=E,
        capacity=min(cap, Tl * k), act=cfg.mlp_act,
        limit=limit).reshape(B, S, d)
