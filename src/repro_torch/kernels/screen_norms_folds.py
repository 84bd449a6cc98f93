"""CUDA kernel 4: fused TLFre screening statistics on the fold-stacked CV
layout (``csrc/screen_norms_folds.cu``).

Replaces the TPU kernel ``src/repro/kernels/screen_norms.py:
screen_norms_folds_pallas``.  It is bound by bytes: a block owns a tile of
groups and a tile of fold x lambda rows and stages the tile's mask in shared
memory once; for ``n_max <= 32`` one thread reduces one (row, group) pair,
so every lane is busy, and wider groups take one warp per pair.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)


def screen_norms_folds_cuda(c_pad: torch.Tensor, mask: torch.Tensor):
    """c_pad: (R, G, n_max) float32 (R = K*L fold x lambda rows), mask:
    (G, n_max) bool shared by every row -> (snorm2 (R, G), cinf (R, G))
    float32."""
    global launches, captured
    if c_pad.dim() != 3:
        raise ValueError("c_pad must be 3-D (rows, groups, n_max)")
    R, G, n_max = c_pad.shape
    build.require(c_pad, "c_pad", torch.float32, (R, G, n_max))
    build.require(mask, "mask", torch.bool, (G, n_max))
    if mask.device != c_pad.device:
        raise ValueError("c_pad and mask must lie on one device")
    lib = build.load()
    snorm2 = torch.empty((R, G), dtype=torch.float32, device=c_pad.device)
    cinf = torch.empty((R, G), dtype=torch.float32, device=c_pad.device)
    err = lib.repro_screen_norms_folds_f32(
        c_pad.data_ptr(), mask.data_ptr(), snorm2.data_ptr(), cinf.data_ptr(),
        R, G, n_max, build.stream_handle(c_pad.device))
    build.check(err, "screen_norms_folds")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return snorm2, cinf
