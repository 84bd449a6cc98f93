"""CUDA kernel 5: the fused Theorem-22 (DPC) threshold on the fold-stacked
CV layout (``csrc/dpc_screen_folds.cu``).

Replaces the TPU kernel ``src/repro/kernels/screen_norms.py:
dpc_screen_folds_pallas``.  It is bound by bytes: one thread per (fold,
column) loads its column norm once and walks a tile of lambda rows, reading
C in place (the ragged tail of p is masked, not padded) and writing the keep
mask as 1-byte bool.  The product and the sum are rounded separately, as in
the plain ``C + r * cn``, because the result is held to exact equality.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0   # launches of the kernel in this process
captured = 0   # calls recorded into CUDA graphs (see ops.count_replay)


def dpc_screen_folds_cuda(C: torch.Tensor, radii: torch.Tensor,
                          col_norms_f: torch.Tensor) -> torch.Tensor:
    """C: (K, L, p) float32, radii: (K, L) float32, col_norms_f: (K, p)
    float32 -> keep (K, L, p) bool."""
    global launches, captured
    if C.dim() != 3:
        raise ValueError("C must be 3-D (folds, lambdas, features)")
    K, L, p = C.shape
    if K > 65535:
        raise ValueError(f"at most 65535 folds, not {K}")
    build.require(C, "C", torch.float32, (K, L, p))
    build.require(radii, "radii", torch.float32, (K, L))
    build.require(col_norms_f, "col_norms_f", torch.float32, (K, p))
    if not (radii.device == col_norms_f.device == C.device):
        raise ValueError("all operands must lie on one device")
    lib = build.load()
    keep = torch.empty((K, L, p), dtype=torch.bool, device=C.device)
    err = lib.repro_dpc_screen_folds_f32(
        C.data_ptr(), radii.data_ptr(), col_norms_f.data_ptr(),
        keep.data_ptr(), K, L, p, build.stream_handle(C.device))
    build.check(err, "dpc_screen_folds")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return keep


def borderline_inputs(K: int, L: int, p: int, seed: int = 0):
    """(C, radii, col_norms, n_flips): float32 numpy inputs on which the
    plain ``C + r * cn`` lands on 1.0 within one ulp everywhere, and
    ``n_flips`` the number of elements whose keep decision a fused
    multiply-add (one rounding) would flip.  A kernel that contracts the
    product into the sum disagrees with the plain version on those."""
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.5, 1.0, (K, L)).astype(np.float32)
    cn = rng.uniform(0.5, 1.0, (K, p)).astype(np.float32)
    q = radii[:, :, None] * cn[:, None, :]               # rounded product
    C = (np.float32(1.0) - q).astype(np.float32)
    # every other column one ulp lower, so both decisions occur
    C[:, :, ::2] = np.nextafter(C[:, :, ::2], np.float32(0.0))
    plain = (C + q) >= np.float32(1.0)
    # the product of two float32 values is exact in float64, and so is its
    # sum with C here; one rounding of that sum to float32 is the fma
    exact = (C.astype(np.float64)
             + radii.astype(np.float64)[:, :, None]
             * cn.astype(np.float64)[:, None, :])
    fused = exact.astype(np.float32) >= np.float32(1.0)
    return C, radii, cn, int((plain != fused).sum())
