"""CUDA kernel 2: fused TLFre screening statistics (``csrc/screen_norms.cu``).

Replaces the TPU kernel ``src/repro/kernels/screen_norms.py:
screen_norms_pallas`` (its two fold-stack siblings are not ported yet).  It
is bound by bytes: one warp per row of the (L*G, n_max) layout reduces
``||S_1(c)||^2`` and ``||c||_inf`` by warp shuffles, and reads the shared
(G, n_max) mask as ``mask[row % G]`` instead of a broadcast copy.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)


def screen_norms_cuda(c_pad: torch.Tensor, mask: torch.Tensor):
    """c_pad: (R, n_max) float32, mask: (G, n_max) bool with R a multiple
    of G -> (snorm2 (R,), cinf (R,)) float32."""
    global launches, captured
    if c_pad.dim() != 2 or mask.dim() != 2:
        raise ValueError("c_pad and mask must be 2-D")
    R, n_max = c_pad.shape
    G = mask.shape[0]
    if G == 0 or R % G != 0:
        raise ValueError(f"rows of c_pad ({R}) must be a multiple of the "
                         f"mask's rows ({G})")
    build.require(c_pad, "c_pad", torch.float32, (R, n_max))
    build.require(mask, "mask", torch.bool, (G, n_max))
    if mask.device != c_pad.device:
        raise ValueError("c_pad and mask must lie on one device")
    lib = build.load()
    snorm2 = torch.empty(R, dtype=torch.float32, device=c_pad.device)
    cinf = torch.empty(R, dtype=torch.float32, device=c_pad.device)
    err = lib.repro_screen_norms_f32(
        c_pad.data_ptr(), mask.data_ptr(), snorm2.data_ptr(), cinf.data_ptr(),
        R, G, n_max, build.stream_handle(c_pad.device))
    build.check(err, "screen_norms")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return snorm2, cinf
