"""Model assembly: parameter trees, the layer stack, the encoder-decoder,
train / prefill / decode (PyTorch port of ``repro.models.model``).

The layer stack is the unrolled ``prologue`` layers (``pro{i}``), then
``repeats`` copies of the ``block_pattern`` period.  Each
parameter keeps the reference's name and stacked shape (``blocks.l0.attn.wq``
is ``(R, d, H, dh)``), and ``decoder_stack`` unbinds each stacked leaf once
a forward and loops over ``r in range(repeats)`` on those slices.  Indexing
``a[r]`` instead would make each slice's backward add a full-size zero
gradient, R of them a leaf.  The stacked layout keeps the semantics that read
stacked leaves: an SGL weight group spans every copy of its layer, the init
fan-in counts the stack axis, and checkpoint leaves come in the reference's
order.

Covered: block kinds ``attn``, ``local``, ``global``, ``dense_ffn_attn``
and ``moe`` with ``qk_norm``, ``rope_theta_local``, tied or untied heads,
the four MLP activations, MLA attention and the MoE FFN with shared experts
(``gemma2-2b``, ``gemma3-12b``, ``nemotron-4-340b``, ``minicpm3-4b``,
``granite-moe-1b-a400m``, ``deepseek-v2-236b``); ``mamba`` and
``mamba+shared_attn`` (Mamba2, and after it one of two ``shared_attn``
attention + MLP blocks, ``shared_attn[r % 2]`` in repeat r; ``zamba2-2.7b``)
and ``mlstm`` / ``slstm`` (``xlstm-350m``); the enc-dec family
(``encdec_forward``: ``encoder`` and ``decoder`` stacks of ``enc_layers`` and
``dec_layers``, cross-attention over the encoder's output, the ``audio``
frontend's precomputed frames; ``seamless-m4t-medium``) and the ``vision``
prefix (precomputed patch embeddings before the tokens, masked out of the
loss; ``llava-next-mistral-7b``).

Under an ``LMMesh`` (``launch.mesh``) each rank computes on its rows of the
batch (``distributed.sharding.local_rows``) with full parameters (the train
step gathers them from the rank's blocks), and ``forward_train`` returns
the reference's global loss: the cross-entropy is the rank's sum over the
global token count, the MoE's auxiliary the rank's share of the global
one, so the ranks' objectives sum to the reference's, and the value
reported on every rank is that sum.  ``seq_shard`` keeps S / |model| rows
of the residual stream a rank between the period's layers.  Another kind
of mesh raises ``TypeError``.

Tensor-parallel serving (``forward_decode(tp=True)``, the prefill step's
``tp``; the attention-only families, ``check_tp``) keeps each rank's
blocks of the parameters by ``distributed.sharding.serving_pspecs`` (a
``TPLayout``) and its rows of the batch: the embedding is a vocab-parallel
lookup, each block runs its rank's heads and channels with the rows summed
over 'model' after the row-parallel ``wo`` and ``w_out``, a MoE layer its
experts and shared-expert channels with one sum for both
(``moe.ExpertSplit``), and the head's vocab-split logits are gathered.
Each rank's cache holds its rows and the kv heads its q heads read, or
under MLA the whole latent (``cache_shapes(tp_mesh_shape=...)``).

The decode cache is a nested dict, a leaf tree a layer of the period
stacked over ``repeats`` plus a ``prologue`` list of unstacked ones:
``KVCache`` (under MLA ``MLACache``) for attention, ``{"mamba":
MambaCache}`` or ``{"mamba": ..., "shared": KVCache}`` for Mamba2 (each
application of a shared block has its own KV cache), ``MLSTMCache`` and
``SLSTMCache``.  Recurrent states are float32, rings and KV rows in the
cache's dtype, the xLSTM stabilisers ``m`` start at -1e30.  The enc-dec
cache is ``{"decoder": {"self": KVCache stacked over dec_layers},
"enc_out": (B, cache_len, d)}``.  Decode writes every cache in place into
its slice of the stack.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.groups import resolve_device
from ..distributed import sharding as sh
from ..pytree import flatten, leaves, plain_structure, tree_map, unflatten
from .common import (P, ParamDesc, constrain, constraint_spec, is_spec,
                     rms_norm, softcap, tree_init, tree_specs)
from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod

ATTN_KINDS = ("attn", "local", "global", "dense_ffn_attn", "moe")
MAMBA_KINDS = ("mamba", "mamba+shared_attn")
KINDS = ATTN_KINDS + MAMBA_KINDS + ("mlstm", "slstm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the first block kind of
    ``cfg`` that the port does not know."""
    parts = [k for k in cfg.prologue + cfg.block_pattern if k not in KINDS]
    if parts:
        raise NotImplementedError(f"{cfg.name}: block kind {parts[0]!r} is "
                                  f"not ported")


#: tensor-parallel serving of the families it does not cover yet: the
#: ROADMAP item that covers each
TP_ITEMS = {"ssm": "item 59 (the xLSTM heads)",
            "hybrid": "item 59 (the Mamba2 heads)", "encdec": "item 60 (the "
            "enc-dec backbone)", "vlm": "item 60 (the vision backbone)"}


def check_tp(cfg: ArchConfig) -> None:
    """Tensor-parallel serving covers the attention-only families (dense
    and MoE, GQA and MLA); another config raises ``NotImplementedError``
    naming the ROADMAP item that covers it."""
    if cfg.family in TP_ITEMS:
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel serving covers the dense and MoE "
            f"families; this config is ROADMAP {TP_ITEMS[cfg.family]}")


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Tensor-parallel serving on ``mesh``: every parameter is this rank's
    block by ``specs`` (``sharding.serving_pspecs``).  ``embed_split`` /
    ``head_split``: the embedding's rows / the head's columns are split
    over 'model' (a tied head is the embedding)."""
    mesh: Any
    specs: Any
    embed_split: bool
    head_split: bool


def tp_layout(cfg: ArchConfig, mesh) -> "TPLayout | None":
    """The serving layout of ``cfg`` on ``mesh`` (``None`` without a mesh:
    nothing is split).  Raises for a config outside the slice
    (``check_tp``)."""
    check_tp(cfg)
    check_mesh(mesh)
    if mesh is None:
        return None
    specs = sh.serving_pspecs(cfg, mesh.shape)
    embed = specs["embed"][0] == "model"
    head = embed if cfg.tie_embeddings else specs["lm_head"][1] == "model"
    return TPLayout(mesh, specs, embed, head)


def check_mesh(mesh) -> None:
    """``mesh`` must be None or an ``LMMesh``; anything else raises
    ``TypeError``."""
    from ..launch.mesh import LMMesh
    if mesh is not None and not isinstance(mesh, LMMesh):
        raise TypeError(f"mesh must be a launch.mesh.LMMesh or None, got "
                        f"{type(mesh).__name__}")


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def _block_descs(cfg: ArchConfig, kind: str):
    d = cfg.d_model
    ln = lambda: ParamDesc((d,), (None,), scale=0.0)
    if kind in MAMBA_KINDS:
        return {"ln": ln(), "mamba": ssm_mod.mamba2_descs(cfg)}
    if kind == "mlstm":
        return {"ln": ln(), "mlstm": xlstm_mod.mlstm_descs(cfg)}
    if kind == "slstm":
        return {"ln": ln(), "slstm": xlstm_mod.slstm_descs(cfg)}
    return {"ln1": ln(), "ln2": ln(),
            "attn": attn.mla_descs(cfg) if cfg.mla else attn.gqa_descs(cfg),
            "ffn": moe_mod.moe_descs(cfg) if kind == "moe"
            else mlp_mod.mlp_descs(cfg)}


def _stack_descs(descs, n):
    return tree_map(
        lambda p: ParamDesc((n,) + p.shape, ("stack",) + p.axes, p.scale,
                            p.dtype), descs)


def param_descs(cfg: ArchConfig):
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    tree: dict[str, Any] = {
        "embed": ParamDesc((V, d), ("vocab", "embed")),
        "final_norm": ParamDesc((d,), (None,), scale=0.0),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamDesc((d, V), ("embed", "vocab"))
    ln = lambda: ParamDesc((d,), (None,), scale=0.0)
    if cfg.family == "encdec":
        enc_block = {"ln1": ln(), "attn": attn.gqa_descs(cfg), "ln2": ln(),
                     "ffn": mlp_mod.mlp_descs(cfg)}
        dec_block = dict(enc_block, ln_x=ln(), xattn=attn.gqa_descs(cfg))
        tree["encoder"] = _stack_descs(enc_block, cfg.enc_layers)
        tree["decoder"] = _stack_descs(dec_block, cfg.dec_layers)
        tree["enc_final_norm"] = ln()
        return tree
    for i, kind in enumerate(cfg.prologue):
        tree[f"pro{i}"] = _block_descs(cfg, kind)
    period = {f"l{i}": _block_descs(cfg, kind)
              for i, kind in enumerate(cfg.block_pattern)}
    tree["blocks"] = _stack_descs(period, cfg.repeats)
    if "mamba+shared_attn" in cfg.block_pattern:
        # two alternating attention + MLP blocks shared by every repeat
        tree["shared_attn"] = _stack_descs(
            {"ln1": ln(), "attn": attn.gqa_descs(cfg), "ln2": ln(),
             "ffn": mlp_mod.mlp_descs(cfg)}, 2)
    return tree


def abstract_params(cfg, param_dtype=torch.float32, *, mode=None,
                    device=None):
    """The ``ParamTree`` as fake tensors (``torch._subclasses.
    FakeTensorMode``: shapes and dtypes, no memory) made in ``mode`` (a new
    one by default) on ``device`` (the fake trace's)."""
    from ..launch.cost_analysis import fake_mode, trace_device
    from .common import _desc_flatten
    mode = mode or fake_mode()
    dev = trace_device(device)
    descs, td = _desc_flatten(param_descs(cfg))
    with mode:
        out = [torch.empty(d.shape, dtype=d.dtype or param_dtype, device=dev)
               for d in descs]
    return unflatten(td, out)


def init_params(cfg, generator: torch.Generator, param_dtype=torch.float32,
                shardings=None):
    """A ``ParamTree`` on the device of ``generator``.  With ``shardings``
    (the parameters' tree of ``NamedSharding``) each leaf is this rank's
    block: drawn whole in the same order, then cut, so its values are those
    of the unsplit draw and the peak is the blocks plus one leaf."""
    local = None
    if shardings is not None:
        local = [s.local for s in leaves(shardings, is_leaf=sh.is_sharding)]
    return tree_init(param_descs(cfg), generator, param_dtype, local)


def param_pspecs(cfg, mesh_shape):
    """The parameters' ``P`` tree on a mesh of ``mesh_shape``."""
    return tree_specs(param_descs(cfg), mesh_shape)


def param_count(cfg) -> int:
    leaves, _ = flatten(param_descs(cfg))
    return int(sum(np.prod(l.shape) for l in leaves))


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def _attn_ffn_block(p, x, positions, cfg, kind, *, cache=None,
                    cache_pos=None, mesh=None, capacity_factor=1.25,
                    tp_specs=None):
    """Returns (x, aux); aux is the MoE's load-balancing loss, 0 for dense
    layers.  A decode ``cache`` is written in place.  ``tp_specs``: the
    block's serving spec tree (``p`` holds this rank's blocks by it), whose
    'model' entries say which dims ``mesh`` splits."""
    window = cfg.window_size if kind == "local" else None
    theta = (cfg.rope_theta_local if kind == "local" and cfg.rope_theta_local
             else cfg.rope_theta)
    heads = mlp_mesh = experts = None
    if tp_specs is not None:
        heads = attn.HeadSplit.of(tp_specs["attn"], mesh)
        if kind == "moe":
            experts = moe_mod.ExpertSplit.of(tp_specs["ffn"])
        elif tp_specs["ffn"]["w_out"][0] == "model":
            mlp_mesh = mesh
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        a_out, _ = attn.mla_forward(p["attn"], h, positions, cfg,
                                    cache=cache, cache_pos=cache_pos,
                                    tp=heads)
    else:
        a_out, _ = attn.gqa_forward(p["attn"], h, positions, cfg,
                                    window=window, rope_theta=theta,
                                    cache=cache, cache_pos=cache_pos,
                                    tp=heads)
    x = x + a_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        f_out, aux = moe_mod.moe_forward(p["ffn"], h, cfg, mesh=mesh,
                                         capacity_factor=capacity_factor,
                                         tp=experts)
    else:
        f_out = mlp_mod.mlp_forward(p["ffn"], h, cfg, tp_mesh=mlp_mesh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f_out, aux


def _write(cache, new):
    """A recurrent layer's next cache, written into ``cache`` (its slice of
    the stack) in place."""
    for dst, src in zip(cache, new):
        dst.copy_(src)


def _block_forward(kind, p, x, positions, cfg, *, cache=None, cache_pos=None,
                   mesh=None, shared=None, capacity_factor=1.25,
                   tp_specs=None):
    """One layer of ``kind``; a decode ``cache`` is written in place.
    ``shared``: the ``shared_attn`` block a ``mamba+shared_attn`` layer
    applies after its Mamba2 (the layer's cache holds its own KV cache).
    ``tp_specs``: the layer's serving spec tree (attention kinds only).
    Returns (x, aux)."""
    if kind in ATTN_KINDS:
        return _attn_ffn_block(p, x, positions, cfg, kind, cache=cache,
                               cache_pos=cache_pos, mesh=mesh,
                               capacity_factor=capacity_factor,
                               tp_specs=tp_specs)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        out, new = ssm_mod.mamba2_forward(
            p["mamba"], h, cfg, cache=None if cache is None
            else cache["mamba"])
        if new is not None:
            _write(cache["mamba"], new)
        x = x + out
        if kind == "mamba+shared_attn":
            h = rms_norm(x, shared["ln1"], cfg.norm_eps)
            a_out, _ = attn.gqa_forward(
                shared["attn"], h, positions, cfg, cache=None if cache is None
                else cache["shared"], cache_pos=cache_pos)
            x = x + a_out
            h = rms_norm(x, shared["ln2"], cfg.norm_eps)
            x = x + mlp_mod.mlp_forward(shared["ffn"], h, cfg)
        return x, zero
    fwd = xlstm_mod.mlstm_forward if kind == "mlstm" \
        else xlstm_mod.slstm_forward
    out, new = fwd(p[kind], h, cfg, cache=cache, mesh=mesh)
    if new is not None:
        _write(cache, new)
    return x + out, zero


# ---------------------------------------------------------------------------
# the decoder stack
# ---------------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """``none``: no checkpoint.  ``full`` (and ``nothing``, the same here):
    a non-reentrant checkpoint of the whole period.  ``dots``: a selective
    checkpoint that saves the matmuls and recomputes the rest.  Any other
    name raises."""
    if policy == "none":
        return fn
    if policy in ("full", "nothing"):
        kw = {}
    elif policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)}
    else:
        raise ValueError(f"unknown remat policy {policy!r}; have none, "
                         f"full, nothing, dots")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _layer_cache(full, r=None):
    """One layer's cache: the tensors of ``full`` (a cache tuple, or a dict
    of them), or their slice ``r`` of the stack (views, so a write lands in
    the stack); None stays None."""
    if full is None:
        return None
    if isinstance(full, dict):
        return {k: _layer_cache(v, r) for k, v in full.items()}
    return full if r is None else type(full)(*(a[r] for a in full))


def _unbind(stacked, n):
    """The n slices of a tree of stacked leaves, one ``unbind`` a leaf: its
    backward stacks the n slices' gradients in one op, where indexing
    a[r] n times would add n full-size gradients."""
    flat, td = flatten(stacked)
    unbound = [a.unbind(0) for a in flat]
    return [unflatten(plain_structure(td), [u[r] for u in unbound])
            for r in range(n)]


def _unstacked(specs):
    """A stacked leaf tree's specs without the stack dim."""
    return tree_map(lambda s: P(*s[1:]), specs, is_leaf=is_spec)


def decoder_stack(params, x, positions, cfg: ArchConfig, *, caches=None,
                  cache_pos=None, mesh=None, remat="full",
                  capacity_factor=1.25, seq_shard=False, layout=None):
    """x: (B, S, d), this rank's rows under a mesh.  caches: None
    (train/prefill) or the tree of ``init_cache``, written in place.
    ``capacity_factor``: the MoE's (None: lossless).  ``seq_shard``: where
    |model| divides S, each 'model' rank keeps S / |model| rows of the
    residual stream between periods; each period gathers them first, under
    its checkpoint, so the tensor a checkpoint keeps is the rank's rows.
    ``layout``: a ``TPLayout`` (``params`` are this rank's blocks by it;
    each layer gets its spec tree).  Returns (x, caches, aux)."""
    check_supported(cfg)
    check_mesh(mesh)
    layer_specs = lambda key, stacked: None
    if layout is not None:
        layer_specs = lambda key, stacked: (
            _unstacked(layout.specs["blocks"][key]) if stacked
            else layout.specs[key])
    act_seq = "model" if seq_shard else None
    x = constrain(x, mesh, ("pod", "data"), act_seq, None)
    split = (mesh is not None and caches is None and seq_shard
             and constraint_spec(x.shape, mesh.shape, None, "model")[1]
             == "model")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # the prologue, unrolled
    for i, kind in enumerate(cfg.prologue):
        c = _layer_cache(caches["prologue"][i] if caches is not None
                         else None)
        x, a = _block_forward(kind, params[f"pro{i}"], x, positions, cfg,
                              cache=c, cache_pos=cache_pos, mesh=mesh,
                              capacity_factor=capacity_factor,
                              tp_specs=layer_specs(f"pro{i}", False))
        aux_total = aux_total + a
    block_caches = caches["blocks"] if caches is not None else None
    per_r = _unbind(params["blocks"], cfg.repeats)
    shared = _unbind(params["shared_attn"], 2) \
        if "shared_attn" in params else None
    period_specs = {f"l{i}": layer_specs(f"l{i}", True)
                    for i in range(len(cfg.block_pattern))}

    def period_body(x, r):
        if split:
            x = sh.gather_seq(x, mesh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.block_pattern):
            c = _layer_cache(block_caches[f"l{i}"], r) \
                if block_caches is not None else None
            x, a = _block_forward(kind, per_r[r][f"l{i}"], x, positions, cfg,
                                  cache=c, cache_pos=cache_pos, mesh=mesh,
                                  shared=shared[r % 2] if shared else None,
                                  capacity_factor=capacity_factor,
                                  tp_specs=period_specs[f"l{i}"])
            x = constrain(x, mesh, ("pod", "data"), act_seq, None)
            aux = aux + a
        return (sh.split_seq(x, mesh) if split else x), aux

    body = _remat_wrap(period_body, remat)
    if split:
        x = sh.split_seq(x, mesh)
    for r in range(cfg.repeats):
        x, aux = body(x, r)
        aux_total = aux_total + aux
    if split:
        x = sh.gather_seq(x, mesh)
    return x, caches, aux_total


# ---------------------------------------------------------------------------
# embedding / logits / loss
# ---------------------------------------------------------------------------

LOSS_CHUNK = 1024


def embed_tokens(params, cfg, tokens, compute_dtype, layout=None):
    """``layout``: a ``TPLayout`` whose embedding rows are split: a
    vocab-parallel lookup, each rank's rows for the tokens of its block and
    0 for the others, summed over 'model'."""
    emb = params["embed"].to(compute_dtype)
    if layout is not None and layout.embed_split:
        n = emb.shape[0]
        local = tokens - layout.mesh.block_index("model") * n
        outside = (local < 0) | (local >= n)
        x = torch.nn.functional.embedding(local.masked_fill(outside, 0), emb)
        x = sh.tp_reduce(x.masked_fill(outside[..., None], 0), layout.mesh)
    else:
        x = torch.nn.functional.embedding(tokens, emb)
    return x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype,
                            device=x.device)


def _head_matrix(params, cfg, compute_dtype):
    if cfg.tie_embeddings:
        return params["embed"].to(compute_dtype).T
    return params["lm_head"].to(compute_dtype)


def logits_fn(params, cfg, x, layout=None):
    """``layout``: a ``TPLayout`` whose head columns are split: this rank's
    vocabulary slice of the logits, gathered over 'model' before the
    cap."""
    w = _head_matrix(params, cfg, x.dtype)
    logits = (x @ w).to(torch.float32)
    if layout is not None and layout.head_split:
        logits = sh.tp_gather(logits, -1, layout.mesh)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def chunked_ce_loss(params, cfg, x, labels, mask=None):
    """Cross-entropy without holding (B, S, V) logits for the backward
    pass: a loop over sequence chunks, each chunk's logits recomputed in the
    backward pass (a non-reentrant checkpoint).  The mean is over the
    mask."""
    tot, n = chunked_ce_sums(params, cfg, x, labels, mask)
    return tot / torch.clamp(n, min=1.0)


def chunked_ce_sums(params, cfg, x, labels, mask=None):
    """``chunked_ce_loss``'s (sum of the masked token losses, mask
    count)."""
    B, S, d = x.shape
    C = min(LOSS_CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of {C}")
    w = _head_matrix(params, cfg, x.dtype)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)

    def chunk_loss(xc, yc, mc):
        logits = (xc @ w).to(torch.float32)
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        return torch.sum((lse - gold) * mc), torch.sum(mc)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // C):
        sl = slice(i * C, (i + 1) * C)
        args = (x[:, sl], labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            l, m = checkpoint(chunk_loss, *args, use_reentrant=False)
        else:
            l, m = chunk_loss(*args)
        tot, n = tot + l, n + m
    return tot, n


# ---------------------------------------------------------------------------
# encoder-decoder (seamless): frames are precomputed embeddings (stub)
# ---------------------------------------------------------------------------

def encdec_forward(params, cfg, frames, tokens, *, mesh=None, remat="full",
                   dec_caches=None, cache_pos=None, enc_out=None,
                   compute_dtype=None):
    """frames: (B, S_enc, d) float embeddings; tokens: (B, S_dec) int64.
    If ``enc_out`` is given (decode), the encoder is skipped.

    The encoder is causal, as the reference's is: each layer is
    ``gqa_forward`` with RoPE at ``arange(S_enc)`` and ``q_pos = k_pos``,
    so its output at t reads no frame after t.  Each decoder layer is
    causal self-attention (``dec_caches``' ``self`` KV cache written in
    place when decoding), then cross-attention over ``enc_out``, then the
    MLP.  ``remat`` checkpoints each layer body.  Under a mesh the rows are
    this rank's, as in ``decoder_stack``.  Returns (y, enc_out, dec_caches
    or None)."""
    check_mesh(mesh)
    if compute_dtype is not None:
        dt = compute_dtype
    elif frames is not None:
        dt = frames.dtype
    else:
        dt = enc_out.dtype

    if enc_out is None:
        x = frames
        pos_e = torch.arange(x.shape[1], device=x.device)

        def enc_body(x, p):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            a, _ = attn.gqa_forward(p["attn"], h, pos_e, cfg)
            x = x + a
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            return x + mlp_mod.mlp_forward(p["ffn"], h, cfg)

        body = _remat_wrap(enc_body, remat)
        for p in _unbind(params["encoder"], cfg.enc_layers):
            x = body(x, p)
        enc_out = rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    y = embed_tokens(params, cfg, tokens, dt)
    if dec_caches is None:
        pos_d = torch.arange(tokens.shape[1], device=y.device)
    else:
        pos_d = torch.full((1,), int(cache_pos), device=y.device)
    self_caches = dec_caches["self"] if dec_caches is not None else None

    def dec_body(y, enc_out, p, r):
        c = _layer_cache(self_caches, r) if self_caches is not None \
            else None
        h = rms_norm(y, p["ln1"], cfg.norm_eps)
        a, _ = attn.gqa_forward(p["attn"], h, pos_d, cfg, cache=c,
                                cache_pos=cache_pos)
        y = y + a
        # cross-attention over the encoder's states (enc_out is fixed)
        h = rms_norm(y, p["ln_x"], cfg.norm_eps)
        y = y + _cross_attention(p["xattn"], h, enc_out, cfg)
        h = rms_norm(y, p["ln2"], cfg.norm_eps)
        return y + mlp_mod.mlp_forward(p["ffn"], h, cfg)

    body = _remat_wrap(dec_body, remat)
    for r, p in enumerate(_unbind(params["decoder"], cfg.dec_layers)):
        y = body(y, enc_out, p, r)
    y = rms_norm(y, params["final_norm"], cfg.norm_eps)
    return y, enc_out, dec_caches


def _cross_attention(p, q_in, kv_in, cfg):
    """q from the decoder's states, k and v from the encoder's; no RoPE, no
    cap, every encoder position visible (``q_pos`` is ``Skv - 1`` for each
    query), GQA grouping as in self-attention."""
    q = torch.einsum("bsd,dhk->bshk", q_in, p["wq"].to(q_in.dtype))
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"].to(q_in.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"].to(q_in.dtype))
    Sq, Skv = q.shape[1], k.shape[1]
    q_pos = torch.full((Sq,), Skv - 1, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    o = attn.sdpa(q, k, v, q_pos, k_pos)
    return torch.einsum("bshk,hkd->bsd", o.to(q_in.dtype),
                        p["wo"].to(q_in.dtype))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype
    fill: float = 0.0


def _tp_cache_dims(cfg, batch, mesh_shape) -> tuple:
    """(rows, kv heads) of a rank's KV cache under the serving layout on a
    mesh of ``mesh_shape``: its rows of the batch where the data axes divide
    it (``sharding.local_rows``), and the kv heads its q heads read (None
    under MLA, whose latent cache is whole on every 'model' rank)."""
    check_tp(cfg)
    kv = None
    if not cfg.mla:
        a = _unstacked(sh.serving_pspecs(cfg, mesh_shape)["blocks"]["l0"])
        split = attn.HeadSplit.of(a["attn"], None)
        _, kv = attn.kv_block(cfg.num_heads, cfg.num_kv_heads,
                              mesh_shape.get("model", 1), 0, split.heads,
                              split.kv)
    dp = sh.dp_axes(mesh_shape)
    if sh.divisible(batch, mesh_shape, dp):
        batch //= int(np.prod([mesh_shape[ax] for ax in dp]))
    return batch, kv


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int,
                 dtype=torch.bfloat16, tp_mesh_shape=None):
    """The decode cache's ``TensorSpec`` tree, one leaf tree a layer of the
    period stacked over ``repeats`` and one a prologue layer, unstacked:
    a ``KVCache`` (under MLA an ``MLACache``; local layers
    ``min(cache_len, window)`` ring slots), ``{"mamba": MambaCache}`` (and
    ``"shared"``, the shared block's ``KVCache``), ``MLSTMCache`` or
    ``SLSTMCache``.  KV rows and conv rings are in ``dtype``, recurrent
    states float32, the xLSTM's ``m`` filled with -1e30.  The enc-dec
    cache is the decoder's self-attention ``KVCache`` stacked over
    ``dec_layers`` and ``enc_out`` (B, cache_len, d): the encoder's length
    is the cache's, as in the reference.  ``tp_mesh_shape``: a rank's cache
    under tensor-parallel serving on a mesh of that shape (its rows and
    the kv heads its q heads read, or MLA's whole latent; the families of
    ``check_tp``)."""
    check_supported(cfg)
    f32 = torch.float32
    kv_heads = None
    if tp_mesh_shape is not None:
        batch, kv_heads = _tp_cache_dims(cfg, batch, tp_mesh_shape)
    if cfg.family == "encdec":
        kv = (cfg.dec_layers,) + attn.gqa_cache_shape(cfg, batch, cache_len)
        return {"decoder": {"self": attn.KVCache(TensorSpec(kv, dtype),
                                                 TensorSpec(kv, dtype))},
                "enc_out": TensorSpec((batch, cache_len, cfg.d_model),
                                      dtype)}

    def layer(kind, stack=()):
        spec = lambda shp, dt=dtype, fill=0.0: TensorSpec(stack + shp, dt,
                                                          fill)
        if kind in MAMBA_KINDS:
            conv, state = ssm_mod.mamba2_cache_shape(cfg, batch)
            out = {"mamba": ssm_mod.MambaCache(spec(conv), spec(state, f32))}
            if kind == "mamba+shared_attn":
                kv = attn.gqa_cache_shape(cfg, batch, cache_len)
                out["shared"] = attn.KVCache(spec(kv), spec(kv))
            return out
        if kind == "mlstm":
            C, n, m, conv = xlstm_mod.mlstm_cache_shape(cfg, batch)
            return xlstm_mod.MLSTMCache(spec(C, f32), spec(n, f32),
                                        spec(m, f32, xlstm_mod.NEG),
                                        spec(conv))
        if kind == "slstm":
            c, n, h, m = xlstm_mod.slstm_cache_shape(cfg, batch)
            return xlstm_mod.SLSTMCache(spec(c, f32), spec(n, f32),
                                        spec(h, f32),
                                        spec(m, f32, xlstm_mod.NEG))
        if cfg.mla and kind != "local":
            shapes = attn.mla_cache_shape(cfg, batch, cache_len)
            return attn.MLACache(*(spec(s) for s in shapes))
        window = cfg.window_size if kind == "local" else None
        shp = attn.gqa_cache_shape(cfg, batch, cache_len, window, kv_heads)
        return attn.KVCache(spec(shp), spec(shp))

    return {"blocks": {f"l{i}": layer(kind, (cfg.repeats,))
                       for i, kind in enumerate(cfg.block_pattern)},
            "prologue": [layer(kind) for kind in cfg.prologue]}


def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device=None,
               tp_mesh_shape=None):
    """``cache_shapes`` filled (zeros, the xLSTM's ``m`` -1e30);
    ``device=None`` is the card."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.full(s.shape, s.fill, dtype=s.dtype,
                                         device=dev),
                    cache_shapes(cfg, batch, cache_len, dtype,
                                 tp_mesh_shape))


# ---------------------------------------------------------------------------
# public steps
# ---------------------------------------------------------------------------

def assemble_inputs(params, cfg, batch, compute_dtype, layout=None):
    """tokens (+ the vision prefix) -> (B, S, d) input states: a vision
    config's ``patches`` (B, num_patches, d), cast to the compute dtype,
    come before the token embeddings.  ``layout``: see
    ``embed_tokens``."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, batch["tokens"], compute_dtype, layout)
    if cfg.frontend == "vision" and "patches" in batch:
        x = torch.cat([batch["patches"].to(compute_dtype), x], dim=1)
    return x


def forward_train(params, cfg: ArchConfig, batch, *, mesh=None, remat="full",
                  compute_dtype=torch.bfloat16, seq_shard=False):
    """Returns (loss, metrics).  batch: tokens/labels, int64 (B, S); an
    enc-dec config's ``frames`` (B, S_enc, d) (metrics ``ce`` alone), a
    vision config's ``patches`` (B, num_patches, d), whose positions the
    loss masks out.

    Under a mesh, ``batch`` is the global batch and ``params`` are full;
    each rank computes its rows (``sharding.local_rows``).  The value of
    ``loss`` and the metrics are the reference's global ones on every
    rank; the gradient of ``loss`` is the rank's objective's (its sum of
    token losses over the global count, plus its share of the MoE's
    auxiliary), which the ranks' gradients sum to the reference's."""
    check_mesh(mesh)
    dp_group = None
    if mesh is not None:
        batch, mesh = sh.local_rows(batch, mesh)
        dp_group = mesh.group(sh.dp_axes(mesh.shape))
    if cfg.family == "encdec":
        y, _, _ = encdec_forward(params, cfg,
                                 batch["frames"].to(compute_dtype),
                                 batch["tokens"], mesh=mesh, remat=remat)
        if dp_group is None:
            loss = chunked_ce_loss(params, cfg, y, batch["labels"])
            return loss, {"ce": loss}
        ce, _ = _global_loss(mesh, *chunked_ce_sums(params, cfg, y,
                                                    batch["labels"]))
        return ce, {"ce": ce.detach()}
    x = assemble_inputs(params, cfg, batch, compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = decoder_stack(params, x, positions, cfg, mesh=mesh,
                              remat=remat, seq_shard=seq_shard)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    labels, mask = batch["labels"], None
    if cfg.frontend == "vision" and "patches" in batch:
        pad = torch.zeros((labels.shape[0], batch["patches"].shape[1]),
                          dtype=labels.dtype, device=labels.device)
        mask = torch.cat([torch.zeros(pad.shape, dtype=torch.float32,
                                      device=x.device),
                          torch.ones(labels.shape, dtype=torch.float32,
                                     device=x.device)], dim=1)
        labels = torch.cat([pad, labels], dim=1)
    if dp_group is None:
        ce = chunked_ce_loss(params, cfg, x, labels, mask)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}
    loss, (ce, aux) = _global_loss(
        mesh, *chunked_ce_sums(params, cfg, x, labels, mask), aux)
    return loss, {"ce": ce, "aux": aux}


def _global_loss(mesh, tot, n, aux=None):
    """The rank's objective ``tot / n_global + 0.01 aux`` carrying the
    global value: the ranks' objectives are summed over the batch axes
    (where every rank holds the whole batch, n_global counts it once a
    rank and each rank's aux is divided by their number, so the sums are
    the means again).  Returns (loss, (ce, aux)) with
    the global ce and aux, detached."""
    dp = sh.dp_axes(mesh.shape)
    n_global = sh.all_reduce_sum(n.detach(), mesh, dp)
    ce_r = tot / torch.clamp(n_global, min=1.0)
    if aux is not None and mesh.batch_replicated:
        aux = aux / mesh.axes_size(dp)   # each rank's aux is the whole
    local = ce_r if aux is None else ce_r + 0.01 * aux
    parts = torch.stack([ce_r.detach(),
                         (aux if aux is not None else ce_r).detach()])
    ce, aux_g = sh.all_reduce_sum(parts, mesh, dp)
    total = ce if aux is None else ce + 0.01 * aux_g
    return local + (total - local).detach(), (ce, aux_g)


def forward_decode(params, cfg: ArchConfig, caches, tokens, pos, *,
                   mesh=None, compute_dtype=torch.bfloat16, tp=False):
    """One decode step.  tokens: (B, 1) int64; pos: the absolute position
    (an int).  Returns (logits (B, 1, V) float32, caches), the caches
    written in place (an enc-dec cache's ``enc_out`` is read, never
    written).  Under a mesh every rank decodes the whole batch (caches and
    tokens replicated, as the reference's loop commits them).

    ``tp``: tensor-parallel serving (``tp_layout``): ``params`` are this
    rank's blocks by ``sharding.serving_pspecs``, ``caches`` its cache
    (``init_cache(tp_mesh_shape=mesh.shape)``), ``tokens`` the global
    batch; each data group decodes its rows and every rank returns the
    whole batch's logits."""
    check_mesh(mesh)
    layout = tp_layout(cfg, mesh) if tp else None
    if layout is not None:
        rows, mesh = sh.local_rows({"tokens": tokens}, mesh)
        tokens = rows["tokens"]
    elif mesh is not None:
        mesh = mesh.replicated_batch()
    if cfg.family == "encdec":
        y, _, _ = encdec_forward(
            params, cfg, None, tokens, dec_caches=caches["decoder"],
            cache_pos=pos, enc_out=caches["enc_out"].to(compute_dtype),
            compute_dtype=compute_dtype)
        return logits_fn(params, cfg, y), caches
    x = embed_tokens(params, cfg, tokens, compute_dtype, layout)
    positions = torch.full((1,), int(pos), device=x.device)
    x, caches, _ = decoder_stack(params, x, positions, cfg, caches=caches,
                                 cache_pos=pos, mesh=mesh, remat="none",
                                 capacity_factor=None, layout=layout)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, x, layout)
    return (logits if layout is None else sh.gather_rows(logits, mesh)), \
        caches
