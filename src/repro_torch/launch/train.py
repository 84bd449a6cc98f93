"""End-to-end LM training driver (PyTorch port of ``repro.launch.train``).

An eager train step on ``make_local_mesh()`` (ZeRO-3 over the ranks of the
initialized ``torch.distributed`` group, each holding its blocks of the
state; one device without a group), the deterministic seekable data
stream, async atomic checkpointing with ``--resume`` (elastic: full arrays
are written, so a checkpoint restores onto any mesh), a straggler
watchdog, and optional SGL structured sparsification (``--sgl-lambda``: the
exact two-level prox on the attention-head and FFN-channel groups after
every step).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --steps 50 --global-batch 8 --seq 256 --device cpu

``--device`` defaults to ``cuda``; without a card that raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..checkpoint import checkpointer as ckpt
from ..data.lm_data import SyntheticLM
from ..distributed import sharding as sh
from ..models import model as model_lib
from ..optim import adamw
from ..pytree import as_dict, leaves, tree_map
from ..sparsity import group_reg
from .mesh import make_local_mesh
from .steps import make_train_step, resolve_cli_device, sync_device


class Watchdog:
    """Straggler / hang mitigation: tracks a running median step time and
    flags steps slower than ``factor`` x median (logged and counted)."""

    def __init__(self, factor: float = 3.0):
        self.times = []
        self.factor = factor
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 50:
            self.times.pop(0)
        slow = len(self.times) > 5 and dt > self.factor * med
        self.flagged += int(slow)
        return slow


def _resolve_group_axis(shape, n_groups: int, recorded: int) -> int:
    """Group axis of a STACKED leaf.

    WeightGroups axes mix stacked and unstacked conventions, so prefer
    whichever of the recorded axis or its stacked shift matches the
    registered group count (deterministic when two axes share a size), then
    fall back to a size scan over the non-stack axes, then to the stacked
    shift (clamped to the last axis)."""
    for ax in (recorded, recorded + 1):
        if 0 < ax < len(shape) and shape[ax] == n_groups:
            return ax
    for ax in range(1, len(shape)):
        if shape[ax] == n_groups:
            return ax
    return min(recorded + 1, len(shape) - 1)


def _leaf_axes(spec, mesh, skip=None) -> tuple:
    """The mesh axes (of more than one rank) that split ``spec``'s dims,
    leaving out dim ``skip``."""
    spec = sh.effective_spec(spec)
    named = {a for i, e in enumerate(spec) if e is not None and i != skip
             for a in (e if isinstance(e, tuple) else (e,))}
    return tuple(a for a in mesh.axis_names
                 if a in named and mesh.shape[a] > 1)


def _global_shape(shape, spec, mesh) -> list:
    """The full leaf's shape from a block's, by its spec on ``mesh``."""
    spec = sh.effective_spec(spec)
    return [n * (mesh.axes_size(e if isinstance(e, tuple) else (e,))
                 if e is not None else 1) for n, e in zip(shape, spec)]


def _prox_leaves(params, cfg, mesh=None, specs=None):
    """(path, group axis, leaf, spec) of every registered weight group's
    leaf, in the reference's order (each group, each block kind).  With
    ``specs`` the leaves are blocks, and the group axis is resolved on the
    full shape."""
    blocks = params["blocks"]
    out = []
    for gw in group_reg.head_groups_for(cfg):
        keys = gw.path.split("/")
        for lname in blocks.keys():
            node = blocks[lname]
            spec = None if specs is None else specs["blocks"][lname]
            for k in keys:
                node = node[k] if hasattr(node, "keys") and k in node \
                    else None
                if node is None:
                    break
                spec = None if spec is None else spec[k]
            if node is None:
                continue
            shape = node.shape if spec is None \
                else _global_shape(node.shape, spec, mesh)
            axis = _resolve_group_axis(shape, gw.n_groups, gw.axis)
            out.append((gw.path, axis, node, spec))
    return out


@torch.no_grad()
def sgl_prox_step(params, cfg, t_lam1, t_lam2, mesh=None, specs=None):
    """Apply the exact SGL prox to the registered weight groups of every
    block kind, in place; returns ``params``.  With ``mesh`` (of several
    ranks) the leaves are this rank's blocks by ``specs``: each group's
    partial squares are summed over the axes that split its other dims."""
    sharded = mesh is not None and mesh.size > 1
    for _, axis, node, spec in _prox_leaves(
            params, cfg, mesh, specs if sharded else None):
        if not sharded:
            node.copy_(group_reg.sgl_weight_prox(node, axis, t_lam1,
                                                 t_lam2))
            continue
        shape = _global_shape(node.shape, spec, mesh)
        axes = _leaf_axes(spec, mesh, skip=axis)
        node.copy_(group_reg.sgl_weight_prox(
            node, axis, t_lam1, t_lam2,
            n_per=int(np.prod(shape)) // shape[axis],
            sum_partial=lambda t: sh.all_reduce_sum(t, mesh, axes)))
    return params


@torch.no_grad()
def prox_zeros(params, cfg, mesh=None, specs=None) -> dict:
    """Exact zeros in each registered group path's leaves (summed over the
    block kinds and, on a mesh, over the ranks' distinct blocks)."""
    sharded = mesh is not None and mesh.size > 1
    out = {}
    for path, _, node, spec in _prox_leaves(
            params, cfg, mesh, specs if sharded else None):
        z = torch.sum(node == 0)
        if sharded:
            z = sh.all_reduce_sum(z, mesh, _leaf_axes(spec, mesh))
        out[path] = out.get(path, 0) + int(z)
    return out


def local_params(params, shardings):
    """This rank's blocks of full parameters, by ``shardings`` (the
    parameters' tree of ``NamedSharding``): each block a copy, so the full
    tensors can then be freed; an unsplit leaf is kept as it is."""
    from ..pytree import ParamTree
    return ParamTree(tree_map(lambda a, s: s.local(a.detach()),
                              as_dict(params), as_dict(shardings)))


def main(argv=None, return_state=False, step_times=None, step_metrics=None):
    """Train on ``launch.mesh.make_local_mesh()`` (every rank of the
    initialized ``torch.distributed`` group a data rank; a mesh of one
    without one); returns the losses (and the final ``TrainState``, this
    rank's blocks, with ``return_state``).  ``step_times``, a list,
    receives each step's seconds (the step alone, as the log prints them);
    ``step_metrics``, a list, each step's ``loss``, ``ce`` and ``aux`` (the
    MoE's load-balancing loss, 0 without experts) as floats, and with the
    prox on, ``zeros``: exact zeros in each group path after its prox."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--sgl-lambda", type=float, default=0.0,
                    help="enable SGL structured sparsity (lambda2 = this, "
                         "lambda1 = alpha*lambda2)")
    ap.add_argument("--sgl-alpha", type=float, default=1.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_cli_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()

    mesh = make_local_mesh()
    mesh_shape = sh.mesh_shape_dict(mesh)
    lead = all(c == 0 for c in mesh.coords.values())
    pspecs = model_lib.param_pspecs(cfg, mesh_shape)
    shardings = sh.named(mesh, adamw.state_pspecs(pspecs))
    data = SyntheticLM(cfg.vocab_size, args.seq, args.global_batch, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # every rank draws the full parameters and keeps its blocks (the full
    # ones are freed here); the moments are zeros of the blocks' shapes
    state = adamw.init_state(local_params(model_lib.init_params(
        cfg, gen, torch.float32), shardings.params))
    start_step = 0

    if args.ckpt_dir and args.resume:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, manifest = ckpt.restore(args.ckpt_dir, last, state,
                                           shardings)
            start_step = last
            if lead:
                print(f"[resume] restored step {last} "
                      f"(saved on mesh {manifest['metadata'].get('mesh')}, "
                      f"restored onto {mesh_shape})")

    train_step = make_train_step(
        cfg, mesh=mesh, remat=args.remat, compute_dtype=torch.float32,
        lr_kwargs=dict(base_lr=args.lr, warmup=20,
                       total=max(args.steps, 100)))

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, mesh=mesh) \
        if args.ckpt_dir else None
    dog = Watchdog()
    # the base lr, not the scheduled one; t_l1 is the group threshold
    t_l1 = args.lr * args.sgl_alpha * args.sgl_lambda
    t_l2 = args.lr * args.sgl_lambda

    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = {k: v.to(dev) for k, v in data.batch_at(step).items()}
            sync_device(dev)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            sync_device(dev)
            dt = time.perf_counter() - t0
            if step_times is not None:
                step_times.append(dt)
            rec = {"loss": loss, "ce": float(metrics["ce"]),
                   "aux": float(metrics["aux"])}
            if args.sgl_lambda > 0:
                sgl_prox_step(state.params, cfg, t_l1, t_l2, mesh, pspecs)
                if step_metrics is not None:
                    rec["zeros"] = prox_zeros(state.params, cfg, mesh,
                                              pspecs)
            if step_metrics is not None:
                step_metrics.append(rec)
            slow = dog.observe(dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                msg = (f"step {step:5d} loss {losses[-1]:.4f} "
                       f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
                if args.sgl_lambda > 0:
                    first = leaves(state.params["blocks"])[0]
                    spec = leaves(shardings.params["blocks"],
                                  is_leaf=sh.is_sharding)[0]
                    stats = group_reg.group_sparsity_stats(
                        spec.gather(first.detach()), 1)
                    msg += f" sparsity {stats}"
                if slow:
                    msg += "  [WATCHDOG: straggler step]"
                if lead:
                    print(msg, flush=True)
            if writer and (step + 1) % args.ckpt_every == 0:
                writer.save(step + 1, state,
                            metadata={"mesh": mesh_shape,
                                      "loss": losses[-1]},
                            shardings=shardings)
        if writer:
            writer.save(args.steps, state, metadata={"mesh": mesh_shape},
                        shardings=shardings)
    finally:
        if writer:
            writer.close()
    if losses and lead:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
              f"straggler flags: {dog.flagged}")
    if return_state:
        return losses, state
    return losses


if __name__ == "__main__":
    main()
