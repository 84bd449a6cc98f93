"""CUDA kernel 3: the fused two-level SGL prox (``csrc/sgl_prox.cu``).

Replaces the TPU kernel ``src/repro/kernels/sgl_prox.py:sgl_prox_pallas``.
It is bound by bytes and, at the path's shapes, by its launch: one warp per
group shrinks, takes the group norm by warp shuffles and scales.  ``t_l1``
is a 1-element device tensor, so no FISTA iteration reads it on the host.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process


def sgl_prox_cuda(v_pad: torch.Tensor, mask: torch.Tensor, t_l1: torch.Tensor,
                  t_group: torch.Tensor) -> torch.Tensor:
    """v_pad: (G, n_max) float32, mask: (G, n_max) bool, t_l1: (1,) float32,
    t_group: (G,) float32 -> (G, n_max) float32 (masked slots zero)."""
    global launches
    if v_pad.dim() != 2:
        raise ValueError("v_pad must be 2-D")
    G, n_max = v_pad.shape
    build.require(v_pad, "v_pad", torch.float32, (G, n_max))
    build.require(mask, "mask", torch.bool, (G, n_max))
    build.require(t_l1, "t_l1", torch.float32, (1,))
    build.require(t_group, "t_group", torch.float32, (G,))
    dev = v_pad.device
    if not (mask.device == t_l1.device == t_group.device == dev):
        raise ValueError("all operands must lie on one device")
    lib = build.load()
    out = torch.empty((G, n_max), dtype=torch.float32, device=dev)
    err = lib.repro_sgl_prox_f32(
        v_pad.data_ptr(), mask.data_ptr(), t_l1.data_ptr(),
        t_group.data_ptr(), out.data_ptr(), G, n_max, build.stream_handle(dev))
    build.check(err, "sgl_prox")
    launches += 1
    return out
