"""Shared model plumbing: parameter descriptors, the init rule, norms, rope,
activations (PyTorch port of ``repro.models.common``).

Every leaf is declared once as a ``ParamDesc`` (shape + logical axes + init
scale).  The port materialises the declarations as a ``ParamTree`` (an
``nn.Module`` whose ``named_parameters()`` are the reference's leaf paths).
The reference's sharding views (``resolve_spec``, ``tree_specs``,
``constrain``) wait for the port's sharding rules (ROADMAP item 41).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..pytree import ParamTree, TreeDef, flatten, unflatten


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple
    axes: tuple              # logical axis name (or None) per dim
    scale: float = 1.0       # stddev multiplier on fan-in init
    dtype: object = None     # override param dtype


def _desc_flatten(descs):
    """Leaves (``ParamDesc``) of a nested dict of descriptors, in the
    reference's order, and the structure as a 'params' tree."""
    leaves, td = flatten(descs)

    def as_params(t: TreeDef) -> TreeDef:
        if t.kind == "leaf":
            return t
        return TreeDef("params" if t.kind == "dict" else t.kind, t.keys,
                       [as_params(c) for c in t.children])
    return leaves, as_params(td)


def tree_init(descs, generator: torch.Generator,
              param_dtype=torch.float32) -> ParamTree:
    """The reference's init rule on the device of ``generator``: a leaf of
    two or more dims draws N(0, 1) * scale / sqrt(prod(shape[:-1])) (the
    stack axis counts in the fan-in), a 1-D leaf is 0 when its scale is 0,
    else 1.  Leaves draw from ``generator`` one after another in the
    reference's order; the values are the port's own."""
    descs_flat, td = _desc_flatten(descs)
    dev = generator.device
    out = []
    for d in descs_flat:
        dt = d.dtype or param_dtype
        if len(d.shape) >= 2:
            fan_in = int(np.prod(d.shape[:-1]))
            std = d.scale / np.sqrt(max(fan_in, 1))
            w = torch.randn(d.shape, generator=generator, device=dev,
                            dtype=dt)
            out.append(w.mul_(torch.tensor(std, dtype=dt, device=dev)))
        elif d.scale == 0.0:
            out.append(torch.zeros(d.shape, dtype=dt, device=dev))
        else:
            out.append(torch.ones(d.shape, dtype=dt, device=dev))
    return unflatten(td, out)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    """In float32, scaled by ``1 + gamma`` in x's dtype (gamma starts at 0)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * (1.0 + gamma.to(dt))


def causal_conv(u, w):
    """Depthwise causal conv, no bias: ``out[:, t] = sum_i u[:, t - K + 1 +
    i] * w[i]`` (zero before the start) for u (B, S, C), w (K, C).  The
    terms are summed in i's order, as the reference's sum over a padded
    copy, but each term is one shifted (B, S, C) tensor: no (B, S + K -
    1, C) copy is made."""
    K, S = w.shape[0], u.shape[1]
    return sum(F.pad(u[:, :S - s] * w[i], (0, 0, s, 0))
               for i, s in ((i, K - 1 - i) for i in range(K)) if s < S)


def softcap(x, cap):
    return torch.tanh(x / cap) * cap


def rope(x, positions, theta: float):
    """x: (..., S, H, dh) with positions (..., S).  Two halves, not
    interleaved; frequencies ``exp(-arange(half) * ln(theta) / half)`` in
    float32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str, x, gate=None):
    """``jax.nn.gelu``'s default is the tanh approximation; so is this."""
    if name == "silu_glu":
        return F.silu(gate) * x
    if name == "gelu_glu":
        return F.gelu(gate, approximate="tanh") * x
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def is_glu(name: str) -> bool:
    return name.endswith("_glu")
