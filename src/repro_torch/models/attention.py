"""Attention: GQA with local windows, softcap and qk-norm (PyTorch port of
the GQA half of ``repro.models.attention``).

Two execution strategies, as in the reference:
  * ``einsum`` — materialises (B, KV, rep, Sq, Skv) scores; short S / decode.
  * ``blocked`` — flash-style online softmax over KV chunks, each q chunk
    recomputed in the backward pass (a non-reentrant checkpoint), so no S^2
    residual is kept.  Local layers visit only the chunks of their band.
``sdpa`` takes ``blocked`` from S >= ``BLOCKED_THRESHOLD`` unless forced.
The scores stay plain torch ops: gemma2's soft-capped scores and the ring
buffer's positions are outside ``F.scaled_dot_product_attention``.

MLA (``mla_descs``, ``mla_forward``, ``MLACache``) waits for ROADMAP item
35; ``models.model.check_supported`` refuses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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


def gqa_forward(p, x, positions, cfg, *, window=None, rope_theta=None,
                cache: Optional[KVCache] = None, cache_pos=None,
                force_impl=None):
    """x: (B, S, d).  Training/prefill when cache is None; decode otherwise.

    Decode contract: x is (B, 1, d), ``cache_pos`` the absolute position (an
    int).  The step's k/v are written into the cache's slot in place, and
    the returned cache is the same tensors.  A local layer's cache holds
    ``min(cache_len, window)`` slots as a ring; slot positions are rebuilt
    from ``cache_pos // S_cache``, unwritten slots get negative positions
    and are masked.
    """
    B, S, d = x.shape
    dh = cfg.head_dim
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
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
    return out, new_cache


def gqa_cache_shape(cfg, batch, cache_len, window=None):
    """Shape of one layer's k (and v) cache."""
    S = min(cache_len, window) if window is not None else cache_len
    return (batch, S, cfg.num_kv_heads, cfg.head_dim)
