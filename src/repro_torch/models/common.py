"""Shared model plumbing: parameter descriptors, the init rule, norms, rope,
activations (PyTorch port of ``repro.models.common``).

Every leaf is declared once as a ``ParamDesc`` (shape + logical axes + init
scale).  The port materialises the declarations as a ``ParamTree`` (an
``nn.Module`` whose ``named_parameters()`` are the reference's leaf paths)
and derives the same ``PartitionSpec`` views as the reference
(``resolve_spec``, ``tree_specs``: logical axes to mesh axes, a dim that
does not divide degrading to replicated).  ``constrain`` resolves an
activation's spec by the reference's rule; the port's tensors are each
rank's block already, so it changes nothing and counts its calls
(``distributed.sharding.constrain_counts``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..pytree import ParamTree, TreeDef, flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple
    axes: tuple              # logical axis name (or None) per dim
    scale: float = 1.0       # stddev multiplier on fan-in init
    dtype: object = None     # override param dtype


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


class P(tuple):
    """A ``PartitionSpec``: one entry a dim, each ``None`` (replicated), a
    mesh axis name or a tuple of names (the dim split over their product,
    the first name major).  As JAX's, a tuple of one name becomes the
    name and an empty tuple ``None``, so ``tuple(P(...))`` equals
    ``tuple()`` of the reference's spec with the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple)
            else p for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


# Logical-axis -> mesh-axis rules, the reference's.  'embed' is the ZeRO-3
# dim of 2-D weights over the combined (pod, data) axis; the tensor-parallel
# axes name 'model'.  A dim shards only when the axes' size exceeds 1 and
# divides it, else it stays replicated.
DEFAULT_RULES: dict = {
    "embed":    (("pod", "data"),),
    "vocab":    ("model",),
    "heads":    ("model",),
    "kv_heads": ("model",),
    "mlp":      ("model",),
    "experts":  ("model",),
    "seq":      (),
    "conv":     (),
    "stack":    (),
    "state":    (),
    None:       (),
}


def resolve_spec(desc: ParamDesc, mesh_shape, rules=None) -> P:
    """Each dim's first candidate of ``rules`` (``DEFAULT_RULES``) whose
    axes, pruned to those of ``mesh_shape``, have a size above 1 that
    divides the dim; else ``None``.  One axis stays a name, several a
    tuple."""
    rules = rules or DEFAULT_RULES
    parts = []
    for size, ax in zip(desc.shape, desc.axes):
        pick = None
        for cand in rules.get(ax, ()):
            axes = cand if isinstance(cand, tuple) else (cand,)
            axes = tuple(a for a in axes if a in mesh_shape)
            if not axes:
                continue
            n = int(np.prod([mesh_shape[a] for a in axes]))
            if n > 1 and size % n == 0:
                pick = axes if len(axes) > 1 else axes[0]
                break
        parts.append(pick)
    return P(*parts)


def tree_specs(descs, mesh_shape, rules=None):
    """``resolve_spec`` over a tree of descriptors (a tree of ``P``)."""
    return tree_map(lambda d: resolve_spec(d, mesh_shape, rules), descs,
                    is_leaf=is_desc)


CONSTRAINTS: dict = {}      # resolved spec -> calls, since the last reset


def constraint_spec(shape, mesh_shape, *spec_parts) -> P:
    """The spec the reference's ``constrain`` gives a tensor of ``shape``:
    axes absent from the mesh are dropped, and an entry whose axes' size
    is 1 or does not divide its dim becomes ``None``."""
    final = []
    for size, p_ in zip(shape, spec_parts):
        if isinstance(p_, tuple):
            p_ = tuple(a for a in p_ if a in mesh_shape) or None
        elif isinstance(p_, str) and p_ not in mesh_shape:
            p_ = None
        if p_ is None:
            final.append(None)
            continue
        axes = p_ if isinstance(p_, tuple) else (p_,)
        n = int(np.prod([mesh_shape[a] for a in axes]))
        final.append(p_ if (n > 1 and size % n == 0) else None)
    return P(*final)


def constrain(x, mesh, *spec_parts):
    """The reference's activation constraint (no-op without a mesh).  The
    port's tensors already hold this rank's rows along the batch axes and
    keep 'model' dims whole (compute is replicated along 'model'), so the
    value is returned as it is; the resolved spec is counted in
    ``CONSTRAINTS``."""
    if mesh is None:
        return x
    shape = list(x.shape)
    if not mesh.batch_replicated:
        # an entry of batch axes names a dim that holds this rank's rows:
        # the reference resolves the global size
        for i, p_ in enumerate(spec_parts[:len(shape)]):
            axes = p_ if isinstance(p_, tuple) else (p_,)
            if p_ is not None and all(a in ("pod", "data") for a in axes):
                shape[i] *= int(np.prod([mesh.shape.get(a, 1)
                                         for a in axes]))
    spec = constraint_spec(shape, mesh.shape, *spec_parts)
    CONSTRAINTS[spec] = CONSTRAINTS.get(spec, 0) + 1
    return x


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
              param_dtype=torch.float32, local=None) -> ParamTree:
    """The reference's init rule on the device of ``generator``: a leaf of
    two or more dims draws N(0, 1) * scale / sqrt(prod(shape[:-1])) (the
    stack axis counts in the fan-in), a 1-D leaf is 0 when its scale is 0,
    else 1.  Leaves draw from ``generator`` one after another in the
    reference's order; the values are the port's own.  ``local``: one
    function a leaf, in that order, applied to each leaf as it is drawn
    (a rank keeping its block)."""
    descs_flat, td = _desc_flatten(descs)
    dev = generator.device
    out = []
    for i, d in enumerate(descs_flat):
        dt = d.dtype or param_dtype
        if len(d.shape) >= 2:
            fan_in = int(np.prod(d.shape[:-1]))
            std = d.scale / np.sqrt(max(fan_in, 1))
            w = torch.randn(d.shape, generator=generator, device=dev,
                            dtype=dt)
            w = w.mul_(torch.tensor(std, dtype=dt, device=dev))
        elif d.scale == 0.0:
            w = torch.zeros(d.shape, dtype=dt, device=dev)
        else:
            w = torch.ones(d.shape, dtype=dt, device=dev)
        out.append(w if local is None else local[i](w))
        del w
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
