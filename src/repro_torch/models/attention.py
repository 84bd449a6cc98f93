"""Attention: GQA with local windows, softcap and qk-norm, and MLA with its
latent cache (PyTorch port of ``repro.models.attention``).

Two execution strategies, as in the reference:
  * ``einsum`` — materialises (B, KV, rep, Sq, Skv) scores; short S / decode.
  * ``blocked`` — flash-style online softmax over KV chunks, each q chunk
    recomputed in the backward pass (a non-reentrant checkpoint), so no S^2
    residual is kept.  Local layers visit only the chunks of their band.
``sdpa`` takes ``blocked`` from S >= ``BLOCKED_THRESHOLD`` unless forced.
The scores stay plain torch ops: gemma2's soft-capped scores and the ring
buffer's positions are outside ``F.scaled_dot_product_attention``.

MLA (``mla_forward``) runs the expanded form for train and prefill, through
``sdpa`` with a value head dim other than the query's, and the absorbed
form for decode: ``W_uk`` folded into the query and ``W_uv`` into the
output, so attention reads the latent cache ``(B, S, kv_lora_rank)`` plus
``(B, S, qk_rope_head_dim)`` and never expands it a head.

Under tensor-parallel serving (``HeadSplit``) a GQA layer holds its 'model'
rank's q heads and the kv heads they read, an MLA layer its heads of
``wq_b`` (or ``wq``), ``wk_b``, ``wv_b`` and ``wo`` beside the whole latent
and rope projections, and the output projection is row-parallel: the
partial outputs are summed over 'model'.  MLA's latent cache is whole on
every 'model' rank (the reference's ``cache_pspecs``), each rank writing
its own copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as sh
from .common import ParamDesc, rms_norm, rope, softcap

BLOCKED_THRESHOLD = 8192
Q_CHUNK = 512
KV_CHUNK = 512

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------

def gqa_descs(cfg):
    d, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    descs = {
        "wq": ParamDesc((d, H, dh), ("embed", "heads", None)),
        "wk": ParamDesc((d, KV, dh), ("embed", "kv_heads", None)),
        "wv": ParamDesc((d, KV, dh), ("embed", "kv_heads", None)),
        "wo": ParamDesc((H, dh, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        descs["q_norm"] = ParamDesc((dh,), (None,), scale=0.0)
        descs["k_norm"] = ParamDesc((dh,), (None,), scale=0.0)
    return descs


def mla_descs(cfg):
    d, H = cfg.d_model, cfg.num_heads
    nope, rp, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    descs = {
        "wkv_a": ParamDesc((d, kvr + rp), ("embed", None)),
        "kv_norm": ParamDesc((kvr,), (None,), scale=0.0),
        "wk_b": ParamDesc((kvr, H, nope), (None, "heads", None)),
        "wv_b": ParamDesc((kvr, H, vd), (None, "heads", None)),
        "wo": ParamDesc((H, vd, d), ("heads", None, "embed")),
    }
    if qr > 0:
        descs["wq_a"] = ParamDesc((d, qr), ("embed", None))
        descs["q_norm"] = ParamDesc((qr,), (None,), scale=0.0)
        descs["wq_b"] = ParamDesc((qr, H, nope + rp), (None, "heads", None))
    else:
        descs["wq"] = ParamDesc((d, H, nope + rp), ("embed", "heads", None))
    return descs


# ---------------------------------------------------------------------------
# core softmax-attention over explicit q, k, v
#   q: (B, Sq, H, dh)   k, v: (B, Skv, KV, dh)
# ---------------------------------------------------------------------------

def _band_mask(q_pos, k_pos, window: Optional[int]):
    """causal (+ optional local window) mask: True = attend.

    k_pos < 0 marks invalid (not-yet-written) cache slots.
    """
    m = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _scores(qg, k, scale, cap):
    """float32 scores (B, KV, rep, Sq, Skv): a product of two bf16 values is
    exact in float32, so casting first is the reference's
    ``preferred_element_type=float32``."""
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if cap is not None:
        s = softcap(s, cap)
    return s


def _einsum_attention(q, k, v, q_pos, k_pos, window, scale, cap):
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, Sq, KV, rep, dh)       # query head h -> KV head h // rep
    s = _scores(qg, k, scale, cap)
    mask = _band_mask(q_pos, k_pos, window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, v.shape[-1])


def _blocked_attention(q, k, v, q_pos, k_pos, window, scale, cap):
    """Flash-style attention: a loop over q chunks, each an online softmax
    over the kv chunks of its band (the reference's chunk order, so the
    same chunks are visited)."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nq = Sq // Q_CHUNK
    dv = v.shape[-1]

    if window is not None:
        n_band = min((window + Q_CHUNK - 1) // KV_CHUNK + 1, Skv // KV_CHUNK)
    else:
        n_band = Skv // KV_CHUNK

    def one_q_chunk(qc, qp, qi: int):
        # qc: (B, Q, KV, rep, dh); qp: (Q,)
        if window is not None:
            last_chunk = (qi * Q_CHUNK + Q_CHUNK - 1) // KV_CHUNK
            first_chunk = max(last_chunk - (n_band - 1), 0)
        else:
            first_chunk = 0
        acc = torch.zeros((B, KV, rep, Q_CHUNK, dv), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((B, KV, rep, Q_CHUNK), NEG_INF,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros((B, KV, rep, Q_CHUNK), dtype=torch.float32,
                            device=q.device)
        for j in range(n_band):
            lo = (first_chunk + j) * KV_CHUNK
            ks, vs = k[:, lo:lo + KV_CHUNK], v[:, lo:lo + KV_CHUNK]
            kp = k_pos[lo:lo + KV_CHUNK]
            s = _scores(qc, ks, scale, cap)
            mask = _band_mask(qp, kp, window)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bskd->bkrqd", p.to(vs.dtype), vs).to(torch.float32)
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        return out.permute(0, 3, 1, 2, 4)          # (B, Q, KV, rep, dh)

    qg = q.reshape(B, Sq, KV, rep, dh)
    outs = []
    for qi in range(nq):
        sl = slice(qi * Q_CHUNK, (qi + 1) * Q_CHUNK)
        if torch.is_grad_enabled():
            outs.append(checkpoint(one_q_chunk, qg[:, sl], q_pos[sl], qi,
                                   use_reentrant=False))
        else:
            outs.append(one_q_chunk(qg[:, sl], q_pos[sl], qi))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, dv).to(v.dtype)


def sdpa(q, k, v, q_pos, k_pos, *, window=None, scale=None, cap=None,
         force_impl: Optional[str] = None):
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    Sq, Skv = q.shape[1], k.shape[1]
    impl = force_impl or ("blocked" if max(Sq, Skv) >= BLOCKED_THRESHOLD
                          and Sq % Q_CHUNK == 0 and Skv % KV_CHUNK == 0
                          else "einsum")
    fn = _blocked_attention if impl == "blocked" else _einsum_attention
    return fn(q, k, v, q_pos, k_pos, window, scale, cap)


# ---------------------------------------------------------------------------
# GQA layer (full / local) with optional KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, KV, dh) — ring buffer for local layers
    v: torch.Tensor


def kv_block(H, KV, m, r, heads: bool, kv: bool) -> tuple:
    """(first, count) of the kv heads that the q heads of 'model' rank
    ``r`` of ``m`` read, global q head h reading kv head h // (H / KV).
    ``heads`` / ``kv``: whether the layout splits the q / kv heads over
    'model'.  Unsplit q heads read every kv head; split kv heads are the
    rank's block; split q heads over unsplit kv heads (|model| does not
    divide KV) read one kv head, when a rank's q heads fall in one group."""
    if not heads:
        return 0, KV
    if kv:
        return r * (KV // m), KV // m
    local, rep = H // m, H // KV
    if rep % local:
        raise NotImplementedError(
            f"{local} q heads a rank straddle kv groups of {rep}: a 'model' "
            f"axis of {m}, neither a divisor nor a multiple of {KV} kv "
            f"heads, is not served")
    return r * local // rep, 1


class HeadSplit(NamedTuple):
    """An attention layer's layout on one 'model' rank of tensor-parallel
    serving: ``heads`` / ``kv``, whether its spec splits the q heads
    (``wo``, and GQA's ``wq`` or MLA's ``wq_b`` / ``wq``, ``wk_b``,
    ``wv_b``) / GQA's kv heads (``wk``, ``wv``) over 'model'."""
    mesh: object
    heads: bool
    kv: bool

    @classmethod
    def of(cls, specs, mesh) -> "HeadSplit":
        """From the layer's spec tree: the heads from ``wo`` (H, dh, d) in
        both families, the kv heads from ``wk`` (d, KV, dh) where the
        layer has one (MLA has none)."""
        return cls(mesh, specs["wo"][0] == "model",
                   "wk" in specs and specs["wk"][1] == "model")

    def kv_heads(self, cfg) -> tuple:
        """``kv_block`` of this rank."""
        return kv_block(cfg.num_heads, cfg.num_kv_heads,
                        self.mesh.axes_size("model"),
                        self.mesh.block_index("model"), self.heads, self.kv)


def _tp_sum(out, tp: Optional[HeadSplit]):
    """A row-parallel ``wo``'s partial output summed over 'model' where the
    heads are split; ``out`` itself otherwise."""
    return sh.tp_reduce(out, tp.mesh) if tp is not None and tp.heads \
        else out


def gqa_forward(p, x, positions, cfg, *, window=None, rope_theta=None,
                cache: Optional[KVCache] = None, cache_pos=None,
                force_impl=None, tp: Optional[HeadSplit] = None):
    """x: (B, S, d).  Training/prefill when cache is None; decode otherwise.

    Decode contract: x is (B, 1, d), ``cache_pos`` the absolute position (an
    int).  The step's k/v are written into the cache's slot in place, and
    the returned cache is the same tensors.  A local layer's cache holds
    ``min(cache_len, window)`` slots as a ring; slot positions are rebuilt
    from ``cache_pos // S_cache``, unwritten slots get negative positions
    and are masked.

    ``tp``: ``p`` holds this 'model' rank's blocks; with the q heads split
    and the kv heads whole, the rank projects only the kv heads its q heads
    read (``HeadSplit.kv_heads``), so the cache holds those, and the output
    is summed over 'model'.  Forward only.
    """
    B, S, d = x.shape
    dh = cfg.head_dim
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    wk, wv = p["wk"], p["wv"]
    if tp is not None and tp.heads and not tp.kv:
        first, n = tp.kv_heads(cfg)
        wk, wv = wk[:, first:first + n], wv[:, first:first + n]

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    new_cache = None
    if cache is None:
        kk, vv = k, v
        q_pos = k_pos = positions
    else:
        if S != 1:
            raise ValueError(f"decode takes one token a step, got S={S}")
        cache_pos = int(cache_pos)
        S_cache = cache.k.shape[1]
        slot = cache_pos % S_cache
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        kk, vv = cache.k, cache.v
        new_cache = cache
        idx = torch.arange(S_cache, device=x.device)
        wraps = cache_pos // S_cache
        k_pos = torch.where(idx <= slot, wraps * S_cache + idx,
                            (wraps - 1) * S_cache + idx)
        q_pos = positions

    o = sdpa(q, kk, vv, q_pos, k_pos, window=window,
             scale=dh ** -0.5, cap=cfg.attn_softcap, force_impl=force_impl)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"].to(x.dtype))
    return _tp_sum(out, tp), new_cache


def gqa_cache_shape(cfg, batch, cache_len, window=None, kv_heads=None):
    """Shape of one layer's k (and v) cache (``kv_heads``: a rank's count
    under tensor-parallel serving, else all of them)."""
    S = min(cache_len, window) if window is not None else cache_len
    return (batch, S, kv_heads or cfg.num_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# MLA layer — latent KV cache (kv_lora + rope dims per token)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    ckv: torch.Tensor      # (B, S, kv_lora_rank)
    krope: torch.Tensor    # (B, S, qk_rope_head_dim), rope applied


def mla_forward(p, x, positions, cfg, *, cache: Optional[MLACache] = None,
                cache_pos=None, force_impl=None,
                tp: Optional[HeadSplit] = None):
    """x: (B, S, d).  Training/prefill (the expanded form) when cache is
    None; decode (the absorbed form) otherwise, with the contract of
    ``gqa_forward``: one token a step, ``cache_pos`` an int, the step's
    latent and rope key written into the cache in place.  Slots past
    ``cache_pos`` are masked (no ring).

    ``tp``: ``p`` holds this 'model' rank's heads of the per-head weights
    (the latent and rope projections whole), both forms run over those
    heads alone, and the output is summed over 'model' where the heads are
    split.  The latent cache is the whole latent.  Forward only."""
    B, S, d = x.shape
    nope, rp = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    w = lambda name: p[name].to(x.dtype)

    if cfg.q_lora_rank > 0:
        qa = rms_norm(x @ w("wq_a"), p["q_norm"], cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", qa, w("wq_b"))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, w("wq"))
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = x @ w("wkv_a")                                  # (B, S, kvr + rp)
    ckv = rms_norm(kv_a[..., :kvr], p["kv_norm"], cfg.norm_eps)
    krope = rope(kv_a[..., kvr:][:, :, None, :], positions,
                 cfg.rope_theta)[:, :, 0, :]               # (B, S, rp)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    scale = (nope + rp) ** -0.5

    if cache is None:
        # the expanded form: the softmax pipeline needs per-position K/V
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, w("wk_b"))
        val = torch.einsum("bsr,rhk->bshk", ckv, w("wv_b"))
        k = torch.cat([k_nope, krope[:, :, None, :].expand(
            k_nope.shape[:3] + (rp,))], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = sdpa(qq, k, val, positions, positions, window=None, scale=scale,
                 cap=cfg.attn_softcap, force_impl=force_impl)
        out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), w("wo"))
        return _tp_sum(out, tp), None

    # the absorbed decode:
    #   score_h(t) = <W_uk_h^T q_nope_h, c_t> + <q_rope_h, k_rope_t>
    #   out_h      = W_uv_h (sum_t p_h(t) c_t)
    if S != 1:
        raise ValueError(f"decode takes one token a step, got S={S}")
    cache_pos = int(cache_pos)
    cache.ckv[:, cache_pos] = ckv[:, 0].to(cache.ckv.dtype)
    cache.krope[:, cache_pos] = krope[:, 0].to(cache.krope.dtype)
    ckv_all = cache.ckv.to(x.dtype)
    k_pos = torch.arange(ckv_all.shape[1], device=x.device)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w("wk_b"))
    s = (torch.einsum("bshr,btr->bhst", q_lat, ckv_all)
         + torch.einsum("bshk,btk->bhst", q_rope,
                        cache.krope.to(x.dtype))).to(torch.float32) * scale
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    s = torch.where((k_pos <= cache_pos)[None, None, None, :], s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", prob, ckv_all)
    o = torch.einsum("bshr,rhv->bshv", o_lat, w("wv_b"))
    out = torch.einsum("bshv,hvd->bsd", o, w("wo"))
    return _tp_sum(out, tp), cache


def mla_cache_shape(cfg, batch, cache_len):
    """Shapes of one layer's latent cache: (ckv, krope)."""
    return ((batch, cache_len, cfg.kv_lora_rank),
            (batch, cache_len, cfg.qk_rope_head_dim))
