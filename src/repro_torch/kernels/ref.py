"""Plain PyTorch versions of the five CUDA kernels.

They compute what the kernels compute, in float32, and are the counterparts
of the JAX package's ``kernels/ref.py`` oracles.  ``ops`` takes them for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""
from __future__ import annotations

import torch


def xtv_ref(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v with float32 accumulation.  X: (N, p), v: (N,) -> (p,)."""
    return torch.sum(X.to(torch.float32) * v.to(torch.float32)[:, None],
                     dim=0)


def screen_norms_ref(c_pad: torch.Tensor, mask: torch.Tensor):
    """Fused screening statistics over the padded group layout.

    c_pad: (R, n_max), mask: (R, n_max) bool, or (G, n_max) with R a
    multiple of G, in which case row r reads mask row r % G (the
    lambda-grid layout ``(L*G, n_max)``).  Returns (||S_1(c_g)||^2,
    ||c_g||_inf), each (R,), float32.
    """
    R, n_max = c_pad.shape
    if mask.shape[0] != R:
        mask = mask.repeat(R // mask.shape[0], 1)
    c = torch.where(mask, c_pad.to(torch.float32), 0.0)
    sh = torch.sign(c) * torch.clamp(torch.abs(c) - 1.0, min=0.0)
    snorm2 = torch.sum(sh * sh, dim=1)
    cinf = torch.max(torch.abs(c), dim=1).values
    return snorm2, cinf


def screen_norms_gather_ref(C: torch.Tensor, pad_index: torch.Tensor,
                            pad_mask: torch.Tensor):
    """Fused screening statistics read from C through the padded view: the
    composition that the kernel fuses.  Gather C (R, p) by ``pad_index``
    (G, n_max) with masked slots as 0, then ``screen_norms_ref`` on the
    (R*G, n_max) layout.  Returns (||S_1(c_{r,g})||^2, ||c_{r,g}||_inf),
    each (R, G), float32."""
    (R, _), (G, n_max) = C.shape, pad_index.shape
    c_pad = torch.where(pad_mask, C[:, pad_index], 0.0)
    snorm2, cinf = screen_norms_ref(c_pad.reshape(R * G, n_max), pad_mask)
    return snorm2.reshape(R, G), cinf.reshape(R, G)


def sgl_prox_ref(v_pad: torch.Tensor, mask: torch.Tensor, t_l1,
                 t_group: torch.Tensor) -> torch.Tensor:
    """Fused SGL prox on the padded layout.

    v_pad: (G, n_max), mask: (G, n_max), t_l1 a scalar or 1-element
    tensor, t_group: (G,).  Returns the padded prox output (invalid slots
    zero), float32.
    """
    if isinstance(t_l1, torch.Tensor):
        t_l1 = t_l1.to(torch.float32).reshape(())
    v = torch.where(mask, v_pad.to(torch.float32), 0.0)
    u = torch.sign(v) * torch.clamp(torch.abs(v) - t_l1, min=0.0)
    norms = torch.sqrt(torch.sum(u * u, dim=1))
    tg = t_group.to(torch.float32)
    scale = torch.where(norms > tg,
                        1.0 - tg / torch.where(norms > 0, norms, 1.0), 0.0)
    return u * scale[:, None]


def sgl_prox_flat_ref(v: torch.Tensor, pad_index: torch.Tensor,
                      pad_mask: torch.Tensor, t_l1,
                      t_group: torch.Tensor) -> torch.Tensor:
    """Fused SGL prox on the flat vector: the composition that the kernel
    fuses.  Gather v (p,) by ``pad_index`` with masked slots as 0, the
    padded prox ``sgl_prox_ref`` in float32, scatter-add onto zeros in v's
    dtype.  Columns that no valid slot covers come out 0."""
    v_pad = torch.where(pad_mask, v[pad_index], 0.0).to(torch.float32)
    out = sgl_prox_ref(v_pad, pad_mask, t_l1, t_group)
    return torch.zeros_like(v).scatter_add_(
        0, pad_index.reshape(-1), out.reshape(-1).to(v.dtype))


def screen_norms_folds_ref(c_pad: torch.Tensor, mask: torch.Tensor):
    """Fused screening statistics on the fold-stacked layout.

    c_pad: (R, G, n_max) with R = K*L fold x lambda rows, mask: (G, n_max)
    shared by every row.  Returns (||S_1(c_{r,g})||^2, ||c_{r,g}||_inf),
    each (R, G), float32.
    """
    c = torch.where(mask[None], c_pad.to(torch.float32), 0.0)
    sh = torch.sign(c) * torch.clamp(torch.abs(c) - 1.0, min=0.0)
    snorm2 = torch.sum(sh * sh, dim=2)
    cinf = torch.amax(torch.abs(c), dim=2)
    return snorm2, cinf


def dpc_screen_folds_ref(C: torch.Tensor, radii: torch.Tensor,
                         col_norms_f: torch.Tensor) -> torch.Tensor:
    """Theorem-22 keep mask ``C + r * ||x_i|| >= 1`` on the fold stack:
    C (K, L, p), radii (K, L), col_norms_f (K, p) -> (K, L, p) bool.  The
    product and the sum are rounded separately, in float32."""
    C = C.to(torch.float32)
    r = radii.to(torch.float32)[:, :, None]
    cn = col_norms_f.to(torch.float32)[:, None, :]
    return (C + r * cn) >= 1.0
