"""Multi-pod dry run: one train, prefill or decode step of every
(architecture x shape x mesh) cell on fake tensors, as rank 0 of a fake
256- or 512-rank world (the counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 forced host devices and
reads XLA's memory and cost analyses.  The port runs the step itself, on
fake tensors (``torch._subclasses.FakeTensorMode``: shapes and dtypes, no
memory, no data) under ``launch.cost_analysis.CostCounter``, on rank 0 of a
``torch.distributed`` world on the ``fake`` backend
(``launch.mesh.fake_world``), whose collectives return at once.  Each cell
reports this rank's peak (its state or parameters and inputs, plus the
step's live bytes, plus what a training loop holds from the step before
(its metrics), plus the library workspaces of the threads that run it), FLOPs and bytes, the collectives by kind (equal to
``distributed.sharding.collective_counts()``), the roofline terms on the
H100 and the useful-FLOPs ratio.  Every cell runs in a process of its own:
the fake world is that process's default group.  Under ``tp_decode_bf16``
(the serving layout, ``distributed.sharding.serving_pspecs``) a decode or
prefill cell holds this rank's parameter blocks and its cache, and runs
the steps with ``tp=True``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both]

Results are appended to ``--out`` (default ``build/dryrun.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from ..configs.all_archs import ALL_ARCHS
from ..configs.base import get_config
from ..distributed import sharding as sh
from ..models import model as model_lib
from ..optim import adamw
from . import cost_analysis as ca
from .steps import (SHAPES, input_specs, make_prefill_step, make_serve_step,
                    make_train_step, shape_supported)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun.json")


def model_flops(cfg, shape_name, *, batch=None, seq=None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts D = new tokens."""
    from ..models.common import is_desc
    from ..pytree import flatten
    n_total = model_lib.param_count(cfg)
    if cfg.num_experts:
        leaves, _ = flatten(model_lib.param_descs(cfg))
        e_params = sum(int(np.prod(l.shape)) for l in leaves
                       if is_desc(l) and cfg.num_experts in l.shape
                       and len(l.shape) >= 3)
        n_active = n_total - e_params + e_params * cfg.experts_per_token \
            / cfg.num_experts
    else:
        n_active = n_total
    S, B, kind = SHAPES[shape_name]
    S, B = seq or S, batch or B
    if kind == "train":
        return 6.0 * n_active * S * B
    if kind == "prefill":
        return 2.0 * n_active * S * B
    return 2.0 * n_active * B


#: hillclimb variants: each maps to step-builder knobs (the reference's)
VARIANTS = {
    "baseline": {},
    "mb8": dict(microbatch=8),
    "mb8_sp": dict(microbatch=8, seq_shard=True),
    "mb8_sp_bf16opt": dict(microbatch=8, seq_shard=True,
                           moment_dtype="bfloat16"),
    "bf16opt": dict(moment_dtype="bfloat16"),
    "repl_decode": dict(replicate_params=True),
    "repl_decode_bf16": dict(replicate_params=True, param_dtype="bfloat16"),
    "tp_decode_bf16": dict(tp_only=True, param_dtype="bfloat16"),
    "decode_bf16": dict(param_dtype="bfloat16"),
    "remat_dots": dict(remat_override="dots"),
    "remat_none": dict(remat_override="none"),
    "mb4_sp": dict(microbatch=4, seq_shard=True),
    "mb16_bf16opt": dict(microbatch=16, moment_dtype="bfloat16"),
    "mb8_bf16opt": dict(microbatch=8, moment_dtype="bfloat16"),
}

def _tp_missing(cfg, kind):
    """Why the port's steps cannot run ``tp_only`` for this cell, or
    None."""
    try:
        model_lib.check_tp(cfg)
    except NotImplementedError as e:
        return str(e)
    if kind == "train":
        return ("tensor-parallel training (the backward through the "
                "boundary ops) is ROADMAP item 61; the serving layout runs "
                "the decode and prefill steps")
    return None


#: knobs the port's steps lack for some cells: each a function of (config,
#: step kind) giving the reason, None where the port has the knob
#: (``replicate_params`` is the port's decode and prefill layout already:
#: every rank holds the whole tree)
MISSING_KNOBS = {"tp_only": _tp_missing}


def _mesh_name(multi_pod, mesh_shape):
    if mesh_shape is not None:
        return "x".join(f"{a}{n}" for a, n in mesh_shape.items())
    return "multi" if multi_pod else "single"


def _tree_bytes(tree) -> int:
    from ..pytree import leaves
    return int(sum(ca.alloc_bytes(t.numel() * t.element_size())
                   for t in leaves(tree) if isinstance(t, torch.Tensor)))


def _storage_bytes(tensors) -> int:
    """Allocator bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = ca.alloc_bytes(st.nbytes())
    return int(sum(seen.values()))


#: cuBLAS threads of a step: the caller's, and in training the autograd
#: engine's device thread, which runs the backward on a handle of its own
_BLAS_THREADS = {"train": 2, "prefill": 1, "decode": 1}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                remat: str = "full", variant: str = "baseline",
                extra_opts=None, mesh_shape=None, cfg=None, batch=None,
                seq=None, compute_dtype=torch.bfloat16,
                cache_dtype=torch.bfloat16, device=None) -> dict:
    """One cell on rank 0 of a fake world: the production mesh (data 16,
    model 16; with ``multi_pod`` pod 2 as well) or ``mesh_shape`` ({} for
    no mesh).  ``cfg`` replaces the registered config (a reduced one);
    ``batch`` / ``seq`` replace the shape's; ``compute_dtype`` is the
    step builders' (``launch.train`` runs float32), ``cache_dtype`` the
    decode cache's.  Initializes the fake
    world as the process's default group and destroys it after: call it
    in a process of its own (``run_cell``)."""
    from ..launch import train as train_mod
    from .mesh import fake_world, lm_mesh
    cfg = cfg or get_config(arch)
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant}
    ok, why = shape_supported(cfg, shape_name)
    opts = dict(VARIANTS.get(variant, {}))
    opts.update(extra_opts or {})
    kind = SHAPES[shape_name][2]
    missing = [why for why in (MISSING_KNOBS[k](cfg, kind) for k in opts
                               if k in MISSING_KNOBS) if why]
    if opts.get("replicate_params") and kind == "train":
        missing.append("the port's train step holds ZeRO-3 blocks: "
                       "replicated parameters are its decode and prefill "
                       "steps' own layout")
    if not ok or missing:
        return dict(rec, status="skipped", reason=why or missing[0])
    if opts.get("remat_override"):
        remat = opts["remat_override"]
    if mesh_shape is None:
        mesh_shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
    n_ranks = int(np.prod(list(mesh_shape.values()))) if mesh_shape else 1
    dev = ca.trace_device(device)
    param_dtype = (torch.bfloat16 if opts.get("param_dtype") == "bfloat16"
                   else torch.float32)
    moment_dtype = (torch.bfloat16 if opts.get("moment_dtype") == "bfloat16"
                    else torch.float32)
    tp = bool(opts.get("tp_only"))
    mode = ca.fake_mode()
    t0 = time.time()
    with fake_world(max(n_ranks, 1)):
        mesh = lm_mesh(mesh_shape) if n_ranks > 1 else None
        spec = input_specs(cfg, shape_name, mesh_shape, cache_dtype,
                           mode=mode, device=dev, batch=batch, seq=seq,
                           tp=tp)
        params = model_lib.abstract_params(cfg, param_dtype, mode=mode,
                                           device=dev)
        if tp and mesh is not None:      # this rank's serving blocks
            params = train_mod.local_params(params, sh.named(
                mesh, sh.serving_pspecs(cfg, mesh.shape)))
        sh.reset_collective_counts()
        if kind == "train":
            if mesh is not None:
                specs = adamw.state_pspecs(model_lib.param_pspecs(
                    cfg, mesh.shape))
                params = train_mod.local_params(
                    params, sh.named(mesh, specs).params)
            state = adamw.abstract_state(params, moment_dtype)
            param_bytes = _tree_bytes(state.params)
            resident = _tree_bytes(state) + _tree_bytes(spec["args"])
            step = make_train_step(cfg, mesh=mesh, remat=remat,
                                   compute_dtype=compute_dtype,
                                   microbatch=opts.get("microbatch", 1),
                                   seq_shard=opts.get("seq_shard", False))
            with mode, ca.CostCounter() as c:
                state, metrics = step(state, spec["args"][0])
            carried = _storage_bytes(metrics.values())
        elif kind == "prefill":
            param_bytes = _tree_bytes(params)
            resident = param_bytes + _tree_bytes(spec["args"])
            carried = 0
            step = make_prefill_step(cfg, mesh=mesh,
                                     compute_dtype=compute_dtype, tp=tp)
            with mode, ca.CostCounter() as c:
                step(params, spec["args"][0])
        else:
            caches, tokens, pos = spec["args"]
            param_bytes = _tree_bytes(params)
            resident = param_bytes + _tree_bytes(spec["args"])
            carried = 0
            step = make_serve_step(cfg, mesh=mesh,
                                   compute_dtype=compute_dtype, tp=tp)
            with mode, ca.CostCounter() as c:
                step(params, caches, tokens, pos)
        tallies = sh.collective_counts()
    seconds = time.time() - t0
    cost = ca.Cost.of(c)
    terms = ca.roofline_terms(cost)
    counted = {ca.TALLY_OF_KIND.get(k, k): v["count"]
               for k, v in c.collectives.items()}
    mf_chip = model_flops(cfg, shape_name, batch=batch, seq=seq) / \
        max(n_ranks, 1)
    # each cuBLAS thread's workspaces, at most (cuBLASLt's only where a
    # bias GEMM runs): a step's peak counts them where the process takes
    # them first, as in a fresh process
    ws = _BLAS_THREADS[kind] * ca.LIBRARY_WORKSPACE_BYTES
    peak = resident + c.peak + carried + ws
    return dict(
        rec, status="ok", n_ranks=n_ranks, kind=kind, remat=remat,
        trace_device=str(dev), trace_s=round(seconds, 1),
        params=model_lib.param_count(cfg),
        memory={"resident_gb": resident / 1e9,
                "step_peak_gb": c.peak / 1e9,
                "workspace_gb": ws / 1e9,
                "peak_gb": peak / 1e9,
                "resident_bytes": resident, "param_bytes": param_bytes,
                "step_peak_bytes": c.peak,
                "carried_bytes": carried, "workspace_bytes": ws,
                "peak_bytes": peak},
        collectives={"counts": c.collective_counts(),
                     "payload_bytes": sum(v["payload_bytes"]
                                          for v in c.collectives.values()),
                     "wire_bytes": c.wire_bytes,
                     "match_tallies": counted == {
                         k: v for k, v in tallies.items() if v}},
        roofline=terms, registry_flops=c.registry_flops,
        model_flops_per_chip=mf_chip,
        useful_flops_ratio=(mf_chip / cost.flops) if cost.flops else None)


def _cell_child(kw):
    try:
        return dryrun_cell(**kw)
    except Exception as e:            # reported in the cell's record
        return {"arch": kw.get("arch"), "shape": kw.get("shape_name"),
                "mesh": _mesh_name(kw.get("multi_pod", False),
                                   kw.get("mesh_shape")),
                "variant": kw.get("variant", "baseline"), "status": "error",
                "error": f"{type(e).__name__}: {e}"[:500],
                "traceback": traceback.format_exc()[-2000:]}


def run_cell(**kw) -> dict:
    """``dryrun_cell(**kw)`` in a spawned process of its own (its fake
    world is that process's default group)."""
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(1) as pool:
        return pool.apply(_cell_child, (kw,))


def append_result(rec, path=RESULTS):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = []
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    key = (rec["arch"], rec["shape"], rec["mesh"],
           rec.get("variant", "baseline"))
    data = [r for r in data
            if (r["arch"], r["shape"], r["mesh"],
                r.get("variant", "baseline")) != key]
    data.append({k: v for k, v in rec.items() if k != "traceback"})
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def have_result(arch, shape, mesh_name, variant="baseline", path=RESULTS):
    if not os.path.exists(path):
        return False
    with open(path) as f:
        data = json.load(f)
    return any((r["arch"], r["shape"], r["mesh"],
                r.get("variant", "baseline")) ==
               (arch, shape, mesh_name, variant)
               and r["status"] in ("ok", "skipped") for r in data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod meshes")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=RESULTS,
                    help="results file (default build/dryrun.json)")
    ap.add_argument("--device", default=None,
                    help="the fake trace's device (default cuda where torch "
                         "is built with it; no card is used)")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp_ in meshes:
                mesh_name = "multi" if mp_ else "single"
                if args.skip_done and have_result(arch, shape, mesh_name,
                                                  args.variant, args.out):
                    print(f"[skip-done] {arch} {shape} {mesh_name}")
                    continue
                tag = f"{arch:26s} {shape:12s} {mesh_name:6s}"
                rec = run_cell(arch=arch, shape_name=shape, multi_pod=mp_,
                               remat=args.remat, variant=args.variant,
                               device=args.device)
                append_result(rec, args.out)
                if rec["status"] == "skipped":
                    print(f"{tag} SKIP  ({rec['reason']})")
                elif rec["status"] == "error":
                    failures += 1
                    print(rec.get("traceback", ""))
                    print(f"{tag} ERROR {rec['error'][:200]}")
                else:
                    r = rec["roofline"]
                    print(f"{tag} OK  ranks={rec['n_ranks']} "
                          f"trace={rec['trace_s']:.1f}s "
                          f"param_bytes={rec['memory']['param_bytes']} "
                          f"peak={rec['memory']['peak_gb']:.2f}GB "
                          f"collectives={rec['collectives']['counts']} "
                          f"tC={r['t_compute']:.3e} tM={r['t_memory']:.3e} "
                          f"tN={r['t_collective']:.3e} dom={r['dominant']} "
                          f"useful={rec['useful_flops_ratio']:.3f}")
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
