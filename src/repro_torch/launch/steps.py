"""Step builders: train / prefill / decode (PyTorch port of the builders of
``repro.launch.steps``).

The reference's ``SHAPES``, ``shape_supported`` and ``input_specs`` serve
its 512-device dry run, which the port leaves out (ROADMAP, out of scope).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import model as model_lib
from ..optim import adamw
from ..pytree import as_dict, leaves, tree_map


def resolve_cli_device(name: str) -> torch.device:
    """The device a CLI's ``--device`` names; ``cuda`` without a card
    raises (the port never falls back to the CPU on its own)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def sync_device(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cast_tree(params, compute_dtype):
    """>= 2-D float32 leaves in the compute dtype (autograd carries the
    gradient back to the float32 master); norms stay float32."""
    return tree_map(lambda a: a.to(compute_dtype)
                    if a.ndim >= 2 and a.dtype == torch.float32 else a,
                    as_dict(params))


def make_train_step(cfg: ArchConfig, mesh=None, remat="full",
                    compute_dtype=torch.bfloat16, lr_kwargs=None,
                    microbatch: int = 1, seq_shard: bool = False,
                    cast_params: bool = True):
    """``train_step(state, batch) -> (state, metrics)``.  microbatch > 1:
    gradient accumulation over equal slices of the batch (the mean of their
    gradients and losses).  cast_params: cast >= 2-D float32 master weights
    to the compute dtype inside the loss.  The state is updated in place.
    A mesh or ``seq_shard`` raises ``NotImplementedError`` (ROADMAP item
    41)."""
    model_lib.refuse_mesh(mesh, seq_shard)
    lr_kwargs = lr_kwargs or {}

    def loss_fn(params, mb):
        if cast_params and compute_dtype != torch.float32:
            params = _cast_tree(params, compute_dtype)
        return model_lib.forward_train(params, cfg, mb, remat=remat,
                                       compute_dtype=compute_dtype)

    def value_and_grad(params, mb):
        (loss, metrics) = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves(params))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def train_step(state: adamw.TrainState, batch):
        if microbatch <= 1:
            loss, metrics, grads = value_and_grad(state.params, batch)
        else:
            grads, loss = None, 0.0
            for i in range(microbatch):
                mb = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = value_and_grad(state.params, mb)
                if grads is None:
                    grads = [gi.to(torch.float32) for gi in g]
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.to(torch.float32))
                loss = loss + l
                del g
            grads = [g / microbatch for g in grads]
            loss = loss / microbatch
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        lr = adamw.cosine_schedule(state.step, **lr_kwargs)
        new_state = adamw.adamw_update(state, grads, lr=lr)
        del grads
        metrics = dict(metrics, loss=loss, lr=lr)
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None,
                      compute_dtype=torch.bfloat16):
    """Full-sequence forward -> last-position logits.  batch: ``tokens``,
    and an enc-dec config's ``frames`` or a vision config's ``patches``."""
    model_lib.refuse_mesh(mesh, False)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            y, _, _ = model_lib.encdec_forward(
                params, cfg, batch["frames"].to(compute_dtype),
                batch["tokens"], remat="none")
        else:
            x = model_lib.assemble_inputs(params, cfg, batch, compute_dtype)
            positions = torch.arange(x.shape[1], device=x.device)
            x, _, _ = model_lib.decoder_stack(params, x, positions, cfg,
                                              remat="none")
            y = model_lib.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return model_lib.logits_fn(params, cfg, y[:, -1:, :])

    return prefill_step


def make_serve_step(cfg: ArchConfig, mesh=None, compute_dtype=torch.bfloat16):
    """``serve_step(params, caches, tokens, pos) -> (next tokens (B, 1),
    caches)``: greedy, the caches written in place."""
    model_lib.refuse_mesh(mesh, False)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, new_caches = model_lib.forward_decode(
            params, cfg, caches, tokens, pos, compute_dtype=compute_dtype)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], new_caches

    return serve_step
