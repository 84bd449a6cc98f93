"""Int8 error-feedback gradient compression (PyTorch port of
``repro.distributed.compression``).

Across pods the gradient all-reduce crosses the slower data-center
network; the standard mitigation quantises the cross-pod summand to int8
with a per-block scale and carries the quantisation error into the next
step (error feedback keeps SGD / Adam unbiased in the long run;
Karimireddy et al., 2019):

    comp, err = compress_tree(grads, err)        # int8 + scales
    grads     = decompress_tree(comp)            # after the pod all-reduce

BLOCK values share one float32 scale, ``max|block| / 127`` (at least
1e-30), so the wire format is 1 byte a value plus 4 / BLOCK bytes of scale.
Everything runs in plain torch on the tensor's device; nothing in either
package calls it yet (ROADMAP §3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..pytree import flatten, leaves, plain_structure, tree_map, unflatten

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor         # int8 payload, padded flat
    scale: torch.Tensor     # float32 per-block scales
    n: int                  # original element count
    shape: tuple            # original shape


def _pad_len(n):
    return -(-n // BLOCK) * BLOCK


def compress(x: torch.Tensor, err: torch.Tensor | None = None):
    """Quantise x + err (error feedback).  Returns (Compressed, new_err):
    the error is float32, of x's shape."""
    shape = tuple(x.shape)
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    if err is not None:
        flat = flat + err.reshape(-1)
    pad = _pad_len(n)
    flat_p = torch.nn.functional.pad(flat, (0, pad - n)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat_p), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(flat_p / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_err = (flat_p - deq).reshape(-1)[:n].reshape(shape)
    return Compressed(q.reshape(-1), scale[:, 0], n, shape), new_err


def decompress(c: Compressed) -> torch.Tensor:
    deq = c.q.reshape(-1, BLOCK).to(torch.float32) * c.scale[:, None]
    return deq.reshape(-1)[:c.n].reshape(c.shape)


def _is_compressed(x) -> bool:
    return isinstance(x, Compressed)


def compress_tree(tree, err_tree=None):
    """``compress`` on every leaf; returns (tree of ``Compressed``, tree of
    errors)."""
    flat, td = flatten(tree)
    errs = leaves(err_tree) if err_tree is not None else [None] * len(flat)
    out = [compress(l, e) for l, e in zip(flat, errs)]
    td = plain_structure(td)
    return (unflatten(td, [c for c, _ in out]),
            unflatten(td, [e for _, e in out]))


def decompress_tree(comp_tree):
    return tree_map(decompress, comp_tree, is_leaf=_is_compressed)


def init_error_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def wire_bytes(tree) -> int:
    """Bytes on the wire for the compressed tree (against 4 a value for
    float32)."""
    total = 0
    for l in leaves(tree):
        n = l.numel()
        total += _pad_len(n) + 4 * (_pad_len(n) // BLOCK)
    return total
