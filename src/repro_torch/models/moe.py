"""Token-choice top-k MoE (PyTorch port of the single-shard path of
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

The expert-parallel ``shard_map`` path waits for the sharding rules
(ROADMAP item 41); a mesh raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

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


def router_topk(p, x, cfg):
    """Returns (expert_idx (B, S, k) int64, gate_w (B, S, k) float32, aux
    scalar).  Ties in the top k go to the lower expert index, as in
    ``jax.lax.top_k``: a stable descending sort, cut to k."""
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


def moe_ffn_local(x_flat, expert_idx, gate_w, w_in, w_gate, w_out, *,
                  e_lo, n_local, capacity, act):
    """MoE contribution of experts [e_lo, e_lo + n_local) to local tokens.

    x_flat: (T, d); expert_idx / gate_w: (T, k).  Returns (T, d) in
    x_flat's dtype; pairs routed to other experts contribute nothing."""
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


def moe_forward(p, x, cfg, *, mesh=None, capacity_factor: float = 1.25):
    """x: (B, S, d) -> ((B, S, d), aux loss).  ``capacity_factor=None`` is
    lossless dispatch (decode)."""
    if mesh is not None:
        from .model import refuse_mesh
        refuse_mesh(mesh, False)
    B, S, d = x.shape
    expert_idx, gate_w, aux = router_topk(p, x, cfg)
    E, k = cfg.num_experts, cfg.experts_per_token
    act = cfg.mlp_act
    Tl = B * S
    out = moe_ffn_local(
        x.reshape(Tl, d), expert_idx.reshape(Tl, k), gate_w.reshape(Tl, k),
        p["w_in"], p["w_gate"] if "w_gate" in p else None, p["w_out"],
        e_lo=0, n_local=E, capacity=capacity_of(Tl, k, E, capacity_factor),
        act=act).reshape(B, S, d)

    if cfg.num_shared_experts:
        h = x @ p["shared_in"].to(x.dtype)
        if is_glu(act):
            h = activation(act, h, x @ p["shared_gate"].to(x.dtype))
        else:
            h = activation(act, h)
        out = out + h @ p["shared_out"].to(x.dtype)
    return out.to(x.dtype), aux
