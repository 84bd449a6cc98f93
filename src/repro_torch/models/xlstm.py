"""xLSTM blocks: the mLSTM (matrix memory, chunked-parallel) and the sLSTM
(scalar memory, strictly sequential) (PyTorch port of
``repro.models.xlstm``).

mLSTM recurrence per head (dh = head dim):

    C_t = f_t C_{t-1} + i_t  k_t ⊗ v_t          (matrix memory, dh x dh)
    n_t = f_t n_{t-1} + i_t  k_t
    h_t = (q_t · C_t) / max(|q_t · n_t|, 1)

with exponential input gate i_t = exp(ĩ_t) and forget gate f_t = σ(f̃_t),
stabilised by the running max m_t.  The chunked form is exact: inside a
chunk the decay-weighted Gram matrix, masked in log space before the
exponential; the carried state keeps its own log scale, so the
stabilisation holds across chunks (the skeleton of ``models.ssm``).
Every contraction has two operands, so no intermediate is larger than
(B, Q, Q, H), (B, S, d_in) or the (B, H, dh, dh) memory.

The sLSTM's train path is a Python loop over time, in two levels when
``S % 128 == 0 and S > 128``: chunks of 128 steps, each recomputed in the
backward pass (a non-reentrant checkpoint), so the backward holds one
chunk's residuals and the chunk boundaries' carries, not S steps'.

Decode returns new caches; ``models.model`` writes them into the stacked
cache in place.  Under a mesh, q, k and v are constrained to their heads
over 'model' and the sLSTM's ``gates_x`` to its last dim over 'model', as in
the reference (``common.constrain``: the values are unchanged, since
compute is replicated along 'model').
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import ParamDesc, causal_conv, constrain, rms_norm

NEG = -1e30
TC = 128          # the sLSTM's time chunk


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_descs(cfg):
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.num_heads
    dh = d_in // H
    return {
        "w_up": ParamDesc((d, d_in), ("embed", "mlp")),
        "w_gate": ParamDesc((d, d_in), ("embed", "mlp")),
        "conv_w": ParamDesc((4, d_in), ("conv", "mlp")),
        "conv_b": ParamDesc((d_in,), ("mlp",), scale=0.0),
        "wq": ParamDesc((d_in, H, dh), ("mlp", "heads", None)),
        "wk": ParamDesc((d_in, H, dh), ("mlp", "heads", None)),
        "wv": ParamDesc((d_in, H, dh), ("mlp", "heads", None)),
        "w_if": ParamDesc((d_in, 2 * H), ("mlp", None)),
        "if_bias": ParamDesc((2 * H,), (None,), scale=0.0),
        "out_norm": ParamDesc((d_in,), ("mlp",), scale=0.0),
        "w_down": ParamDesc((d_in, d), ("mlp", "embed")),
    }


class MLSTMCache(NamedTuple):
    C: torch.Tensor      # (B, H, dh, dh) float32: matrix memory (scaled)
    n: torch.Tensor      # (B, H, dh) float32
    m: torch.Tensor      # (B, H) float32: log scale of C, n
    conv: torch.Tensor   # (B, 3, d_in)


def _mlstm_chunked(q, k, v, li, lf, chunk):
    """q, k, v: (B, S, H, dh) float32; li / lf: (B, S, H) log input /
    forget gates.  Returns y: (B, S, H, dh).  Exact stabilised chunked
    evaluation."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    Sp = -(-S // Q) * Q
    if Sp != S:  # pad with li = NEG (no input), lf = 0 (keep the state)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, Sp - S)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, Sp - S), value=NEG)
        lf = F.pad(lf, (0, 0, 0, Sp - S))
    scale = dh ** -0.5
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    Ct = torch.zeros((B, H, dh, dh), dtype=q.dtype, device=q.device)
    nt = torch.zeros((B, H, dh), dtype=q.dtype, device=q.device)
    mt = torch.full((B, H), NEG, dtype=q.dtype, device=q.device)
    ys = []
    for c in range(Sp // Q):
        sl = slice(c * Q, (c + 1) * Q)
        qq, kk, vv, lii, lff = q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl]
        la = torch.cumsum(lff, dim=1)          # (B,Q,H) inclusive log decay
        la_last = la[:, -1, :]                 # (B,H)
        # g_ij = la_i - la_j + li_j   (j <= i)
        g = torch.where(mask, la[:, :, None, :] - la[:, None, :, :]
                        + lii[:, None, :, :], NEG)
        c_i = la + mt[:, None, :]              # the carry's term (B,Q,H)
        m_i = torch.clamp(torch.maximum(torch.amax(g, dim=2), c_i),
                          min=-1e29)
        w_ij = torch.exp(g - m_i[:, :, None, :])                  # (B,i,j,H)
        qk = torch.einsum("bihd,bjhd->bijh", qq, kk) * scale
        a = qk * w_ij
        qs = qq * scale
        carry = torch.exp(c_i - m_i)
        num = torch.einsum("bijh,bjhd->bihd", a, vv) + carry[..., None] \
            * torch.einsum("bihd,bhde->bihe", qs, Ct)
        den = a.sum(dim=2) + carry * torch.einsum("bihd,bhd->bih", qs, nt)
        y = num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None]
        # the carried state, at its own log scale
        g_end = la_last[:, None, :] - la + lii                    # (B,Q,H)
        m_new = torch.maximum(la_last + mt, torch.amax(g_end, dim=1))
        kw = kk * torch.exp(g_end - m_new[:, None, :])[..., None]
        f_s = torch.exp(la_last + mt - m_new)
        Ct = f_s[..., None, None] * Ct + torch.einsum("bjhd,bjhe->bhde",
                                                      kw, vv)
        nt = f_s[..., None] * nt + kw.sum(dim=1)
        mt = m_new
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S]


def mlstm_forward(p, x, cfg, *, cache: Optional[MLSTMCache] = None,
                  chunk: int = 256, mesh=None):
    """x: (B, S, d).  Train / prefill when ``cache`` is None; otherwise one
    decode step (S = 1).  Returns (out, new cache or None)."""
    from .model import check_mesh
    check_mesh(mesh)
    B, S, d = x.shape
    H = cfg.num_heads
    d_in = 2 * d
    dh = d_in // H
    u = x @ p["w_up"].to(x.dtype)
    z = x @ p["w_gate"].to(x.dtype)
    w = p["conv_w"].to(x.dtype)

    if cache is None:
        conv = causal_conv(u, w)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token a step, got S={S}")
        hist = torch.cat([cache.conv.to(x.dtype), u], dim=1)
        conv = sum(hist[:, i:i + 1, :] * w[i] for i in range(w.shape[0]))
        new_conv = hist[:, 1:, :]
    conv = F.silu(conv + p["conv_b"].to(x.dtype))

    proj = lambda a, name: torch.einsum(
        "bsd,dhk->bshk", a, p[name].to(x.dtype)).to(torch.float32)
    q, k, v = proj(conv, "wq"), proj(conv, "wk"), proj(u, "wv")
    q = constrain(q, mesh, ("pod", "data"), None, "model", None)
    k = constrain(k, mesh, ("pod", "data"), None, "model", None)
    v = constrain(v, mesh, ("pod", "data"), None, "model", None)
    gates = (u @ p["w_if"].to(x.dtype)
             + p["if_bias"].to(x.dtype)).to(torch.float32)
    li, lf = gates[..., :H], F.logsigmoid(gates[..., H:])

    new_cache = None
    if cache is None:
        y = _mlstm_chunked(q, k, v, li, lf, chunk)
    else:
        scale = dh ** -0.5
        lf1, li1 = lf[:, 0], li[:, 0]                   # (B,H)
        k1, qs = k[:, 0], q[:, 0] * scale
        m_new = torch.maximum(lf1 + cache.m, li1)
        f_s = torch.exp(lf1 + cache.m - m_new)
        i_s = torch.exp(li1 - m_new)
        C = f_s[..., None, None] * cache.C + i_s[..., None, None] \
            * torch.einsum("bhd,bhe->bhde", k1, v[:, 0])
        n = f_s[..., None] * cache.n + i_s[..., None] * k1
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.einsum("bhd,bhd->bh", qs, n)
        y = (num / torch.maximum(torch.abs(den),
                                 torch.exp(-m_new))[..., None])[:, None]
        new_cache = MLSTMCache(C, n, m_new, new_conv.to(cache.conv.dtype))

    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    return y @ p["w_down"].to(x.dtype), new_cache


def mlstm_cache_shape(cfg, batch):
    """Shapes of one layer's ``MLSTMCache``: C, n, m (float32) and the conv
    ring (the cache's dtype)."""
    d_in = 2 * cfg.d_model
    H = cfg.num_heads
    dh = d_in // H
    return MLSTMCache((batch, H, dh, dh), (batch, H, dh), (batch, H),
                      (batch, 3, d_in))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_descs(cfg):
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    f_up = int(d * 4 / 3) // 64 * 64 or 64
    return {
        "w_gates": ParamDesc((d, 4 * d), ("embed", "mlp")),   # z,i,f,o
        "r_gates": ParamDesc((H, dh, 4 * dh), (None, None, "mlp")),
        "gate_bias": ParamDesc((4 * d,), ("mlp",), scale=0.0),
        "up1": ParamDesc((d, f_up), ("embed", "mlp")),
        "up2": ParamDesc((d, f_up), ("embed", "mlp")),
        "down": ParamDesc((f_up, d), ("mlp", "embed")),
    }


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, H, dh) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor   # (B, H, dh)


def _slstm_cell(carry, gates_x, r_w):
    """One time step.  gates_x: (B, 4 d) input contribution; r_w: (H, dh,
    4 dh).  Returns the next (c, n, h, m)."""
    c, n, h, m = carry
    B, H, dh = c.shape
    rec = torch.einsum("bhd,hde->bhe", h, r_w)          # (B,H,4 dh)
    g = gates_x.reshape(B, H, 4 * dh) + rec
    z, i_raw, f_raw, o = torch.split(g, dh, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m, i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(lf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.maximum(f_s * n + i_s, torch.exp(-m_new))
    h_new = o * c_new / n_new
    return c_new, n_new, h_new, m_new


def _slstm_steps(carry, g_seq, r_w):
    """The cell over g_seq (T, B, 4 d): (last carry, h of every step
    (T, B, H, dh))."""
    hs = []
    for g_t in g_seq:
        carry = _slstm_cell(carry, g_t, r_w)
        hs.append(carry[2])
    return carry, torch.stack(hs)


def _slstm_chunk(c, n, h, m, g_chunk, r_w):
    (c, n, h, m), hs = _slstm_steps((c, n, h, m), g_chunk, r_w)
    return c, n, h, m, hs


def slstm_forward(p, x, cfg, *, cache: Optional[SLSTMCache] = None,
                  mesh=None):
    """x: (B, S, d).  Train / prefill when ``cache`` is None; otherwise one
    decode step (S = 1).  Returns (out, new cache or None)."""
    from .model import check_mesh
    check_mesh(mesh)
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H
    gates_x = (x @ p["w_gates"].to(x.dtype)
               + p["gate_bias"].to(x.dtype)).to(torch.float32)
    gates_x = constrain(gates_x, mesh, ("pod", "data"), None, "model")
    r_w = p["r_gates"].to(torch.float32)

    if cache is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, torch.full_like(zeros, NEG))
        g_seq = gates_x.transpose(0, 1)                 # (S, B, 4 d)
        if S % TC == 0 and S > TC:
            # two levels: each chunk of TC steps recomputed in the backward
            hs = []
            for i in range(S // TC):
                args = (*carry, g_seq[i * TC:(i + 1) * TC], r_w)
                if torch.is_grad_enabled():
                    *carry, h_c = checkpoint(_slstm_chunk, *args,
                                             use_reentrant=False)
                else:
                    *carry, h_c = _slstm_chunk(*args)
                hs.append(h_c)
            hs = torch.cat(hs)
        else:
            _, hs = _slstm_steps(carry, g_seq, r_w)
        y = hs.transpose(0, 1).reshape(B, S, d)
        new_cache = None
    else:
        if S != 1:
            raise ValueError(f"decode takes one token a step, got S={S}")
        new_cache = SLSTMCache(*_slstm_cell(tuple(cache), gates_x[:, 0], r_w))
        y = new_cache.h.reshape(B, 1, d)

    y = y.to(x.dtype)
    ff = F.gelu(y @ p["up1"].to(x.dtype), approximate="tanh") \
        * (y @ p["up2"].to(x.dtype))
    return ff @ p["down"].to(x.dtype), new_cache


def slstm_cache_shape(cfg, batch):
    """Shapes of one layer's ``SLSTMCache``: four (B, H, dh), float32."""
    s = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return SLSTMCache(s, s, s, s)
