"""Plain PyTorch versions of the three CUDA kernels.

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
