"""CUDA kernel 3: the fused two-level SGL prox on the flat vector
(``csrc/sgl_prox.cu``).

Replaces the TPU kernel ``src/repro/kernels/sgl_prox.py:sgl_prox_pallas``
together with the gather and scatter that the reference wraps around it
(``path_engine._padded_prox``).  At the path's shapes its bytes take
nanoseconds and its launch is what it costs, so it is one launch per FISTA
iteration: segments of P = next_pow2(n_max) <= 32 lanes reduce one group
each (several groups a warp for small ``n_max``), and extra blocks zero the
columns no valid slot covers.  ``t_l1`` is a 1-element device tensor, so no
FISTA iteration reads it on the host.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)


def sgl_prox_cuda(v: torch.Tensor, pad_index: torch.Tensor,
                  pad_mask: torch.Tensor, uncovered: torch.Tensor,
                  t_l1: torch.Tensor, t_group: torch.Tensor) -> torch.Tensor:
    """v: (p,) float32, pad_index: (G, n_max) int64, pad_mask: (G, n_max)
    bool, uncovered: (p,) bool (columns no valid slot covers), t_l1: (1,)
    float32, t_group: (G,) float32 -> (p,) float32.

    Each column must be covered by at most one valid slot (``GroupSpec``
    checks that when it is built)."""
    global launches, captured
    if v.dim() != 1 or pad_index.dim() != 2:
        raise ValueError("v must be 1-D and pad_index 2-D")
    (p,), (G, n_max) = v.shape, pad_index.shape
    build.require(v, "v", torch.float32, (p,))
    build.require(pad_index, "pad_index", torch.int64, (G, n_max))
    build.require(pad_mask, "pad_mask", torch.bool, (G, n_max))
    build.require(uncovered, "uncovered", torch.bool, (p,))
    build.require(t_l1, "t_l1", torch.float32, (1,))
    build.require(t_group, "t_group", torch.float32, (G,))
    dev = v.device
    if not all(t.device == dev for t in (pad_index, pad_mask, uncovered,
                                         t_l1, t_group)):
        raise ValueError("all operands must lie on one device")
    lib = build.load()
    out = torch.empty(p, dtype=torch.float32, device=dev)
    err = lib.repro_sgl_prox_f32(
        v.data_ptr(), pad_index.data_ptr(), pad_mask.data_ptr(),
        uncovered.data_ptr(), t_l1.data_ptr(), t_group.data_ptr(),
        out.data_ptr(), G, n_max, p, build.stream_handle(dev))
    build.check(err, "sgl_prox")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
