"""End-to-end LM training driver (PyTorch port of ``repro.launch.train``).

An eager train step on one device, the deterministic seekable data stream,
async atomic checkpointing with ``--resume``, a straggler watchdog, and
optional SGL structured sparsification (``--sgl-lambda``: the exact
two-level prox on the attention-head and FFN-channel groups after every
step).  No mesh: sharded training and elastic resume wait for ROADMAP item
41.

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
from ..models import model as model_lib
from ..optim import adamw
from ..pytree import leaves
from ..sparsity import group_reg
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


@torch.no_grad()
def sgl_prox_step(params, cfg, t_lam1, t_lam2):
    """Apply the exact SGL prox to the registered weight groups of every
    block kind, in place; returns ``params``."""
    blocks = params["blocks"]
    for gw in group_reg.head_groups_for(cfg):
        keys = gw.path.split("/")
        for lname in blocks.keys():
            node = blocks[lname]
            for k in keys:
                node = node[k] if hasattr(node, "keys") and k in node \
                    else None
                if node is None:
                    break
            if node is None:
                continue
            axis = _resolve_group_axis(node.shape, gw.n_groups, gw.axis)
            node.copy_(group_reg.sgl_weight_prox(node, axis, t_lam1, t_lam2))
    return params


def main(argv=None, return_state=False, step_times=None, step_metrics=None):
    """Train; returns the losses (and the final ``TrainState`` with
    ``return_state``).  ``step_times``, a list, receives each step's
    seconds (the step alone, as the log prints them); ``step_metrics``, a
    list, each step's ``loss``, ``ce`` and ``aux`` (the MoE's
    load-balancing loss, 0 without experts) as floats."""
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

    data = SyntheticLM(cfg.vocab_size, args.seq, args.global_batch, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model_lib.init_params(cfg, gen, torch.float32)
    state = adamw.init_state(params)
    start_step = 0

    if args.ckpt_dir and args.resume:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, manifest = ckpt.restore(args.ckpt_dir, last, state)
            start_step = last
            print(f"[resume] restored step {last} "
                  f"(saved with {manifest['metadata']}, restored onto "
                  f"{dev})")

    train_step = make_train_step(
        cfg, remat=args.remat, compute_dtype=torch.float32,
        lr_kwargs=dict(base_lr=args.lr, warmup=20,
                       total=max(args.steps, 100)))

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
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
            if step_metrics is not None:
                step_metrics.append({"loss": loss,
                                     "ce": float(metrics["ce"]),
                                     "aux": float(metrics["aux"])})
            if args.sgl_lambda > 0:
                sgl_prox_step(state.params, cfg, t_l1, t_l2)
            slow = dog.observe(dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                msg = (f"step {step:5d} loss {losses[-1]:.4f} "
                       f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
                if args.sgl_lambda > 0:
                    stats = group_reg.group_sparsity_stats(
                        leaves(state.params["blocks"])[0], 1)
                    msg += f" sparsity {stats}"
                if slow:
                    msg += "  [WATCHDOG: straggler step]"
                print(msg, flush=True)
            if writer and (step + 1) % args.ckpt_every == 0:
                writer.save(step + 1, state,
                            metadata={"device": str(dev),
                                      "loss": losses[-1]})
        if writer:
            writer.save(args.steps, state, metadata={"device": str(dev)})
    finally:
        if writer:
            writer.close()
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
              f"straggler flags: {dog.flagged}")
    if return_state:
        return losses, state
    return losses


if __name__ == "__main__":
    main()
