"""Mamba2 (SSD) block: the chunked parallel form for train / prefill and the
one-step recurrence for decode (PyTorch port of ``repro.models.ssm``).

State-space recurrence per head h (P = head dim, N = state dim):

    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)        a_t = exp(dt_t * A_h) < 1
    y_t = C_t · h_t + D_h * x_t

The chunked form keeps one state a chunk of ``ssm_chunk`` steps: the
outputs inside a chunk come from the (Q, Q) decay-weighted Gram matrix,
the state is carried from chunk to chunk by a Python loop (the reference's
``lax.scan``).  ``xh``, ``dt``, ``A``, ``B``, ``C`` and the state are
float32 whatever the compute dtype, as in the reference.

Two deliberate differences from the reference's code, neither of which
changes a forward value:

* The decay ``exp(la_i - la_j)`` is masked before the exponential, not
  after.  In the upper triangle ``la_i - la_j`` is a positive sum of
  ``dt |A|`` that overflows float32 at a chunk of 256 steps; the reference
  then multiplies the ``inf`` by a zero cotangent and its gradient is NaN.
  Here the masked entries are ``exp(-inf) = 0`` and the gradient is
  finite.
* Every contraction has two operands (a scale first, then one einsum), so
  no path depends on ``opt_einsum`` choosing the order: no intermediate
  is larger than (B, Q, Q, H), the ``in_proj`` output or the state.

Decode returns a new ``MambaCache`` (the shifted conv ring and the state);
``models.model`` writes it into its slice of the stacked cache in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import ParamDesc, causal_conv, rms_norm


def mamba2_descs(cfg):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return {
        "in_proj": ParamDesc((d, 2 * d_in + 2 * N + H), ("embed", "mlp")),
        "conv_w": ParamDesc((cfg.ssm_conv, conv_dim), ("conv", "mlp")),
        "conv_b": ParamDesc((conv_dim,), ("mlp",), scale=0.0),
        "a_log": ParamDesc((H,), (None,), scale=0.0),
        "dt_bias": ParamDesc((H,), (None,), scale=0.0),
        "d_skip": ParamDesc((H,), (None,)),
        "out_norm": ParamDesc((d_in,), ("mlp",), scale=0.0),
        "out_proj": ParamDesc((d_in, d), ("mlp", "embed")),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, conv_w - 1, conv_dim) ring of recent inputs
    state: torch.Tensor    # (B, H, N, P) float32


def _split_proj(cfg, proj):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    z, xc, Bm, Cm, dt = torch.split(proj, [d_in, d_in, N, N, H], dim=-1)
    return z, xc, Bm, Cm, dt, d_in, H, N


def _ssd_chunked(xdt, la_step, Bf, Cf, Q):
    """The chunked scan.  xdt: (B, S, H, P), la_step: (B, S, H), Bf / Cf:
    (B, S, N), all float32.  Returns y (B, S, H, P) without the skip."""
    B, S, H, P = xdt.shape
    N = Bf.shape[-1]
    Sp = -(-S // Q) * Q
    if Sp != S:  # pad the tail (zero dt: zero update, outputs discarded)
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, Sp - S))
        la_step, Bf, Cf = (F.pad(t, (0, 0, 0, Sp - S))
                           for t in (la_step, Bf, Cf))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xdt.device))[None, :, :, None]
    hstate = torch.zeros((B, H, N, P), dtype=xdt.dtype, device=xdt.device)
    ys = []
    for c in range(Sp // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xdt_q, la_q, B_q, C_q = xdt[:, sl], la_step[:, sl], Bf[:, sl], Cf[:, sl]
        la = torch.cumsum(la_q, dim=1)                             # inclusive
        la_last = la[:, -1:, :]                                    # (B,1,H)
        # intra-chunk: mask in log space, then exponentiate
        cb = torch.einsum("bin,bjn->bij", C_q, B_q)
        decay = torch.exp(torch.where(
            mask, la[:, :, None, :] - la[:, None, :, :], -torch.inf))
        w_ij = cb[..., None] * decay                               # (B,i,j,H)
        y = torch.einsum("bijh,bjhp->bihp", w_ij, xdt_q)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bin,bhnp->bihp", C_q, hstate) \
            * torch.exp(la)[..., None]
        # the chunk's final state
        h_end = torch.einsum("bjn,bjhp->bhnp", B_q,
                             xdt_q * torch.exp(la_last - la)[..., None])
        hstate = torch.exp(la_last[:, 0, :, None, None]) * hstate + h_end
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S]


def mamba2_forward(p, x, cfg, *, cache: Optional[MambaCache] = None):
    """x: (B, S, d).  Train / prefill when ``cache`` is None; otherwise one
    decode step (S = 1) that returns the next ``MambaCache``.  Returns
    (out, new cache or None)."""
    B, S, d = x.shape
    P = cfg.ssm_head_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xc, Bm, Cm, dt, d_in, H, N = _split_proj(cfg, proj)

    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    w, b = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if cache is None:
        conv_out = F.silu(causal_conv(conv_in, w) + b)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token a step, got S={S}")
        hist = torch.cat([cache.conv.to(x.dtype), conv_in], dim=1)
        out = sum(hist[:, i:i + 1, :] * w[i] for i in range(w.shape[0]))
        conv_out = F.silu(out + b)
        new_conv = hist[:, 1:, :]

    xc, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)
    xh = xc.reshape(B, S, H, P).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["a_log"].to(torch.float32))                    # (H,)
    la_step = dt * A                                                # log a_t
    Bf, Cf = Bm.to(torch.float32), Cm.to(torch.float32)
    xdt = xh * dt[..., None]                                        # (B,S,H,P)

    new_cache = None
    if cache is None:
        y = _ssd_chunked(xdt, la_step, Bf, Cf, min(cfg.ssm_chunk, S))
    else:
        a = torch.exp(la_step[:, 0])                                # (B,H)
        upd = torch.einsum("bn,bhp->bhnp", Bf[:, 0], xdt[:, 0])
        state = a[..., None, None] * cache.state + upd
        y = torch.einsum("bn,bhnp->bhp", Cf[:, 0], state)[:, None]
        new_cache = MambaCache(new_conv.to(cache.conv.dtype), state)

    y = y + p["d_skip"].to(torch.float32)[:, None] * xh
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), new_cache


def mamba2_cache_shape(cfg, batch):
    """Shapes of one layer's ``MambaCache``: (conv ring, state); the ring is
    in the cache's dtype, the state float32."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return MambaCache((batch, cfg.ssm_conv - 1, d_in + 2 * N),
                      (batch, H, N, cfg.ssm_head_dim))
