"""CUDA kernel 2: fused TLFre screening statistics, read from the screen
GEMM's output through the group spec's padded view
(``csrc/screen_norms.cu``).

Replaces the TPU kernel ``src/repro/kernels/screen_norms.py:
screen_norms_pallas`` together with the gather by ``pad_index`` and the
masking in front of it (``screening._grid_group_stats``), so the
``(L, G, n_max)`` padded copy of C never exists.  It is bound by bytes
(and, at the path's few MB, by the latency of its round trips): a block
stages a tile's ``pad_index`` / ``pad_mask`` in shared memory once and
reuses them for a chunk of rows; one thread per (row, group) pair reads its
slots from C through the read-only cache for ``n_max <= 32``, a warp per
pair above.  Its fold-stack sibling is ``screen_norms_folds``.
"""
from __future__ import annotations

import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)

_MAX_COLUMNS = 2**31 - 1   # the kernel holds a column index in an int32


def screen_norms_cuda(C: torch.Tensor, pad_index: torch.Tensor,
                      pad_mask: torch.Tensor):
    """C: (R, p) float32, pad_index: (G, n_max) int64, pad_mask: (G, n_max)
    bool -> (snorm2 (R, G), cinf (R, G)) float32.

    Valid slots must point into [0, p) (``GroupSpec`` checks that when it
    is built); a masked slot counts as 0 whatever it points at."""
    global launches, captured
    if C.dim() != 2 or pad_index.dim() != 2:
        raise ValueError("C and pad_index must be 2-D")
    (R, p), (G, n_max) = C.shape, pad_index.shape
    if p > _MAX_COLUMNS:
        raise ValueError(f"C has {p} columns; the kernel takes at most "
                         f"{_MAX_COLUMNS}")
    build.require(C, "C", torch.float32, (R, p))
    build.require(pad_index, "pad_index", torch.int64, (G, n_max))
    build.require(pad_mask, "pad_mask", torch.bool, (G, n_max))
    dev = C.device
    if pad_index.device != dev or pad_mask.device != dev:
        raise ValueError("C, pad_index and pad_mask must lie on one device")
    lib = build.load()
    snorm2 = torch.empty((R, G), dtype=torch.float32, device=dev)
    cinf = torch.empty((R, G), dtype=torch.float32, device=dev)
    err = lib.repro_screen_norms_f32(
        C.data_ptr(), pad_index.data_ptr(), pad_mask.data_ptr(),
        snorm2.data_ptr(), cinf.data_ptr(), R, p, G, n_max,
        build.stream_handle(dev))
    build.check(err, "screen_norms")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return snorm2, cinf
