"""Step builders: train / prefill / decode, and the input specs of every
(architecture x assigned shape) cell (PyTorch port of
``repro.launch.steps``).

``input_specs(cfg, shape_name)`` returns (step kind, fake inputs, ``P``
tree): fake tensors (``torch._subclasses.FakeTensorMode``) in place of the
reference's ``ShapeDtypeStruct``s, for ``launch.dryrun``.

The prefill and serve steps take ``tp=True`` for tensor-parallel serving
(the reference dry run's ``tp_only`` layout; ``models.model.tp_layout``):
the caller holds this rank's parameter blocks by ``distributed.sharding.
serving_pspecs`` and, for decode, its cache; every rank returns the whole
batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed import sharding as sh
from ..models import model as model_lib
from ..optim import adamw
from ..pytree import as_dict, leaves, tree_map


SHAPES = {
    # name: (seq_len, global_batch, step kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k decode skipped "
                       "(DESIGN.md)")
    if shape_name.startswith("decode") and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def input_specs(cfg: ArchConfig, shape_name: str, mesh_shape=None,
                cache_dtype=torch.bfloat16, *, mode=None, device=None,
                batch: int = None, seq: int = None, tp: bool = False) -> dict:
    """``{kind, args, arg_pspecs, seq, batch}`` of one cell: ``args`` are
    fake tensors made in ``mode`` (a ``FakeTensorMode``; a new one by
    default) on ``device`` (the fake trace's, ``cost_analysis.
    trace_device``), excluding the parameters or state.  train / prefill:
    ``args = (batch,)``; decode: ``(caches, tokens, pos)``, ``pos`` the
    last position (an int, as ``forward_decode`` takes it).  Tokens are
    int64, the port's index dtype.  ``batch`` / ``seq`` override the
    shape's.  ``tp``: the caches are a rank's under tensor-parallel
    serving on a mesh of ``mesh_shape`` (``arg_pspecs`` stay the
    reference's)."""
    from .cost_analysis import fake_mode, trace_device
    from ..models.common import P
    mode = mode or fake_mode()
    dev = trace_device(device)
    mesh_shape = mesh_shape or {}
    S, B, kind = SHAPES[shape_name]
    S, B = seq or S, batch or B
    dp = sh.dp_axes(mesh_shape)
    dp_total = int(np.prod([mesh_shape.get(a, 1) for a in dp])) if dp else 1
    bdim = dp if (dp and B % dp_total == 0 and B >= dp_total) else None

    with mode:
        def tok(shape):
            return torch.empty(shape, dtype=torch.int64, device=dev)

        def act(shape):
            return torch.empty(shape, dtype=torch.bfloat16, device=dev)

        if kind in ("train", "prefill"):
            args, specs = {}, {}
            if cfg.family == "encdec":
                args["frames"] = act((B, S, cfg.d_model))
                specs["frames"] = P(bdim, None, None)
                n_tok = S
            elif cfg.frontend == "vision":
                args["patches"] = act((B, cfg.num_patches, cfg.d_model))
                specs["patches"] = P(bdim, None, None)
                n_tok = S - cfg.num_patches
            else:
                n_tok = S
            args["tokens"] = tok((B, n_tok))
            specs["tokens"] = P(bdim, None)
            if kind == "train":
                args["labels"] = tok((B, n_tok))
                specs["labels"] = P(bdim, None)
            return {"kind": kind, "args": (args,), "arg_pspecs": (specs,),
                    "seq": S, "batch": B}
        caches = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
            model_lib.cache_shapes(cfg, B, S, cache_dtype,
                                   mesh_shape if tp else None))
        tokens = tok((B, 1))
    return {"kind": "decode", "args": (caches, tokens, S - 1),
            "arg_pspecs": (sh.cache_pspecs(cfg, B, S, mesh_shape),
                           P(bdim, None), P()),
            "seq": S, "batch": B}


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

    Under a mesh of several ranks (ZeRO-3), ``state`` holds this rank's
    blocks by ``state_pspecs(param_pspecs(cfg, mesh.shape))`` and ``batch``
    is the global batch.  The loss gathers the blocks (after the cast, as
    the reference gathers cast shards; expert dims stay local), the
    gradients come back summed over the batch axes as the rank's blocks,
    and AdamW clips by the full tree's norm.  With ``microbatch`` each
    rank splits its own rows.  ``seq_shard``: see
    ``models.model.decoder_stack``."""
    model_lib.check_mesh(mesh)
    lr_kwargs = lr_kwargs or {}
    sharded = mesh is not None and mesh.size > 1
    specs = model_lib.param_pspecs(cfg, mesh.shape) if sharded else None
    descs = model_lib.param_descs(cfg) if sharded else None

    def loss_fn(params, mb):
        if cast_params and compute_dtype != torch.float32:
            params = _cast_tree(params, compute_dtype)
        if sharded:
            params = sh.gather_params(params, specs, descs, mesh)
        return model_lib.forward_train(params, cfg, mb, mesh=mesh,
                                       remat=remat,
                                       compute_dtype=compute_dtype,
                                       seq_shard=seq_shard)

    def split(batch, i):
        """Microbatch ``i``: the i-th slice of each rank's rows, so its
        global rows are rank-major (the rows ``local_rows`` hands out)."""
        B = next(iter(batch.values())).shape[0]
        n = 1
        if sharded and sh.divisible(B, mesh.shape, sh.dp_axes(mesh.shape)):
            n = mesh.axes_size(sh.dp_axes(mesh.shape))
        return {k: v.reshape((n, microbatch, B // (n * microbatch))
                             + v.shape[1:])[:, i].reshape(
                                 (B // microbatch,) + v.shape[1:])
                for k, v in batch.items()}

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
                l, _, g = value_and_grad(state.params, split(batch, i))
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
        if sharded:
            sh.reduce_grads(grads, specs, mesh)
        lr = adamw.cosine_schedule(state.step, **lr_kwargs)
        new_state = adamw.adamw_update(state, grads, lr=lr,
                                       mesh=mesh if sharded else None,
                                       param_specs=specs)
        del grads
        metrics = dict(metrics, loss=loss, lr=lr)
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None,
                      compute_dtype=torch.bfloat16, tp: bool = False):
    """Full-sequence forward -> last-position logits.  batch: ``tokens``,
    and an enc-dec config's ``frames`` or a vision config's ``patches``.
    Under a mesh each rank runs its rows of the global batch (full
    parameters; with ``tp`` its blocks by ``sharding.serving_pspecs``)
    and every rank returns the whole batch's logits."""
    model_lib.check_mesh(mesh)
    layout = model_lib.tp_layout(cfg, mesh) if tp else None

    @torch.no_grad()
    def prefill_step(params, batch):
        m = mesh
        if m is not None:
            batch, m = sh.local_rows(batch, m)
        if cfg.family == "encdec":
            y, _, _ = model_lib.encdec_forward(
                params, cfg, batch["frames"].to(compute_dtype),
                batch["tokens"], mesh=m, remat="none")
        else:
            x = model_lib.assemble_inputs(params, cfg, batch, compute_dtype,
                                          layout)
            positions = torch.arange(x.shape[1], device=x.device)
            x, _, _ = model_lib.decoder_stack(params, x, positions, cfg,
                                              mesh=m, remat="none",
                                              layout=layout)
            y = model_lib.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = model_lib.logits_fn(params, cfg, y[:, -1:, :], layout)
        return logits if m is None else sh.gather_rows(logits, m)

    return prefill_step


def make_serve_step(cfg: ArchConfig, mesh=None, compute_dtype=torch.bfloat16,
                    tp: bool = False):
    """``serve_step(params, caches, tokens, pos) -> (next tokens (B, 1),
    caches)``: greedy, the caches written in place.  Under a mesh every
    rank decodes the whole batch (``forward_decode``); with ``tp``, each
    data group its rows over this rank's blocks and cache, and every rank
    returns the whole batch's tokens."""
    model_lib.check_mesh(mesh)
    if tp:
        model_lib.check_tp(cfg)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, new_caches = model_lib.forward_decode(
            params, cfg, caches, tokens, pos, mesh=mesh,
            compute_dtype=compute_dtype, tp=tp)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], new_caches

    return serve_step
