"""Batched decode loop with a KV cache (PyTorch port of
``repro.launch.serve``): teacher-forced prefill through the decode step,
greedy decode, warm-only per-step p50 / p99 and tokens per second, on
``make_local_mesh()`` with the caches and tokens replicated (every rank of
an initialized ``torch.distributed`` group decodes the whole batch, as the
reference's loop commits them to the replicated sharding).  An enc-dec
config decodes, as the reference's loop does, against the cache's all-zero
``enc_out``: the loop runs no encoder.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --batch 4 --prompt-len 16 --gen 32 --device cpu

``--device`` defaults to ``cuda``; without a card that raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..models import model as model_lib
from .mesh import make_local_mesh
from .steps import make_serve_step, resolve_cli_device, sync_device


def main(argv=None, latencies=None):
    """Returns the generated tokens, (batch, gen) numpy.  ``latencies``, a
    list, receives the seconds of every generated step (the first, cold
    one included; the printed statistics drop it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_cli_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh = make_local_mesh()
    init_gen = torch.Generator(device=dev).manual_seed(0)
    params = model_lib.init_params(cfg, init_gen, torch.float32)
    serve_step = make_serve_step(cfg, mesh=mesh, compute_dtype=torch.float32)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=dev)
    caches = model_lib.init_cache(cfg, args.batch, args.cache_len,
                                  torch.float32, device=dev)

    # teacher-forced prefill via the decode path (exercises the cache)
    t0 = time.perf_counter()
    for t in range(args.prompt_len - 1):
        _, caches = serve_step(params, caches, prompts[:, t:t + 1], t)
    out = []
    lat = []
    tok = prompts[:, -1:]
    for t in range(args.prompt_len - 1, args.prompt_len - 1 + args.gen):
        ts = time.perf_counter()
        tok, caches = serve_step(params, caches, tok, t)
        sync_device(dev)
        lat.append(time.perf_counter() - ts)
        out.append(tok.cpu().numpy())
    total = time.perf_counter() - t0
    gen = np.concatenate(out, axis=1)
    if latencies is not None:
        latencies.extend(lat)
    # warm-only stats: the first generated step is dropped whenever another
    # sample exists; throughput is over the warm steps only
    warm = lat[1:] if len(lat) > 1 else lat
    lat_ms = np.asarray(warm) * 1e3
    warm_s = float(np.sum(warm))
    if any(mesh.coords.values()):
        return gen
    print(f"generated {gen.shape} tokens; total {total:.2f}s "
          f"(incl. prefill); "
          f"per-step p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms; "
          f"warm throughput {args.batch * len(warm) / warm_s:.1f} tok/s")
    print("sample:", gen[0, :16].tolist())
    return gen


if __name__ == "__main__":
    main()
