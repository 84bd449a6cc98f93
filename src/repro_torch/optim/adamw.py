"""AdamW and the cosine schedule as plain functions on tensors (PyTorch port
of ``repro.optim.adamw``).

The state mirrors the parameter tree: float32 master parameters (a
``ParamTree``) and float32 moments ``m``, ``v`` (nested dicts of the same
leaves).  ``adamw_update`` updates the parameters and moments in place, one
leaf at a time, so a full-width model needs no second copy of its state;
its arithmetic is the reference's: a global-norm clip, bias corrections at
``step + 1`` and decoupled weight decay on every leaf.

Under ZeRO-3 (``state_pspecs``: the state sharded as the parameters) each
rank's state holds its blocks; the update is elementwise on them, and the
clip's norm counts every element of the full tree once
(``distributed.sharding.global_sq_norm``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..pytree import as_dict, leaves, tree_map


class TrainState(NamedTuple):
    step: torch.Tensor         # () int32
    params: Any                # float32 master (ParamTree)
    m: Any
    v: Any


def init_state(params, moment_dtype=torch.float32) -> TrainState:
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                   device=p.device),
                             as_dict(params))
    dev = leaves(params)[0].device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      zeros(), zeros())


def abstract_state(abstract_params, moment_dtype=torch.float32) -> TrainState:
    """The ``TrainState`` of fake parameters (``models.model.
    abstract_params``), as fake tensors in their mode: float32 masters (a
    ``ParamTree``, so they take gradients), moments in ``moment_dtype``, an
    int32 step."""
    from ..pytree import flatten, unflatten
    flat, td = flatten(abstract_params)
    f32 = unflatten(td, [p.new_empty(p.shape, dtype=torch.float32).detach()
                         for p in flat])
    mom = lambda: tree_map(lambda p: p.new_empty(p.shape, dtype=moment_dtype),
                           as_dict(abstract_params))
    return TrainState(flat[0].new_empty((), dtype=torch.int32), f32, mom(),
                      mom())


def state_pspecs(param_specs) -> TrainState:
    """The ``TrainState`` of specs: ``step`` replicated, the parameters
    and both moments by ``param_specs``."""
    from ..models.common import P
    return TrainState(P(), param_specs, param_specs, param_specs)


def cosine_schedule(step, *, base_lr=3e-4, warmup=100, total=10000,
                    min_ratio=0.1):
    """float32 learning rate at ``step`` (a tensor): a linear warmup from 0,
    then a cosine down to ``min_ratio * base_lr``."""
    step = step.to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.minimum(warm, cos)


@torch.no_grad()
def adamw_update(state: TrainState, grads, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, mesh=None,
                 param_specs=None) -> TrainState:
    """One step.  ``grads``: a tree with the parameters' leaves (or a list
    in their order).  Parameters and moments change in place; the returned
    state holds the same tensors and ``step + 1``.  With ``mesh`` the
    leaves are this rank's blocks by ``param_specs``."""
    flat_p = leaves(state.params)
    flat_g = grads if isinstance(grads, list) else leaves(grads)
    flat_m, flat_v = leaves(state.m), leaves(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("state and gradients differ in structure")
    if mesh is not None and mesh.size > 1:
        from ..distributed.sharding import global_sq_norm
        gsq = global_sq_norm(flat_g, param_specs, mesh)
    else:
        gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                  for g in flat_g)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)

    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        # the reference's expressions, evaluated in its order, in place
        g = g.to(torch.float32) * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m32.mul_(b1).add_((1 - b1) * g)
        v32.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = m32 / bc1
        delta.div_(torch.sqrt(v32 / bc2).add_(eps))
        delta.add_(weight_decay * p)
        p.sub_(lr * delta)
        del delta
        if m32 is not m:                  # moments kept in a lower dtype
            m.copy_(m32)
            v.copy_(v32)
    return TrainState(step, state.params, state.m, state.v)
