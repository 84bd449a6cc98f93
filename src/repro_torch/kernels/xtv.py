"""CUDA kernel 1: the certification GEMV ``out = X^T v`` (``csrc/xtv.cu``).

Replaces the TPU kernel ``src/repro/kernels/xtv.py:xtv_pallas``.  It is
bound by bytes: one thread per output column streams X once, in place, with
coalesced row-major loads and float32 accumulation; the ragged tail is
masked and X is neither copied nor padded.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process


def xtv_cuda(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X: (N, p) float32 contiguous, v: (N,) float32 -> (p,) float32."""
    global launches
    if X.dim() != 2:
        raise ValueError("X must be 2-D")
    N, p = X.shape
    build.require(X, "X", torch.float32, (N, p))
    build.require(v, "v", torch.float32, (N,))
    if v.device != X.device:
        raise ValueError("X and v must lie on one device")
    lib = build.load()
    out = torch.empty(p, dtype=torch.float32, device=X.device)
    err = lib.repro_xtv_f32(X.data_ptr(), v.data_ptr(), out.data_ptr(), N, p,
                            build.stream_handle(X.device))
    build.check(err, "xtv")
    launches += 1
    return out
