"""CUDA kernel 1: the certification GEMV ``out = X^T v`` (``csrc/xtv.cu``).

Replaces the TPU kernel ``src/repro/kernels/xtv.py:xtv_pallas``.  It is
bound by bytes: a block owns 32 columns read as 128-bit loads, its 32 row
lanes split N and meet in shared memory in a fixed order, so p = 10 000
already spreads over two waves of 132 SMs.  Narrower X also splits N across
blocks, into a scratch buffer that a second pass sums in chunk order.  X is
read in place, never copied or padded, the ragged tail is masked, and the
result is the same on every run (no atomics).
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)


def xtv_cuda(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X: (N, p) float32 contiguous, v: (N,) float32 -> (p,) float32."""
    global launches, captured
    if X.dim() != 2:
        raise ValueError("X must be 2-D")
    N, p = X.shape
    build.require(X, "X", torch.float32, (N, p))
    build.require(v, "v", torch.float32, (N,))
    if v.device != X.device:
        raise ValueError("X and v must lie on one device")
    lib = build.load()
    out = torch.empty(p, dtype=torch.float32, device=X.device)
    chunks = lib.repro_xtv_chunks(N, p)
    partial = (torch.empty((chunks, p), dtype=torch.float32, device=X.device)
               if chunks > 1 else out)
    err = lib.repro_xtv_f32(X.data_ptr(), v.data_ptr(), out.data_ptr(),
                            partial.data_ptr(), N, p,
                            build.stream_handle(X.device))
    build.check(err, "xtv")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return out
