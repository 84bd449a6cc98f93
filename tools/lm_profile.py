#!/usr/bin/env python3
"""Where the port's LM train step and decode step spend their time on the
card: for each step, wall per step without a tracer and CUPTI's records
over a few warm steps (device busy time per step, kernels per step, the
kernels that take the most time; ``chip_smoke.DeviceTrace``); then, for
each step again, ``torch.profiler`` over a few more (the host operators
and CUDA API calls that take the most time).

    python3 tools/lm_profile.py [--train gemma2-100m:8:256 gemma2-2b:2:256]
                                [--decode gemma2-2b:4:128]

Each ``--train`` item is ``arch:batch:seq`` (float32, TF32 off, remat
none, the SGL prox off; iid tokens from ``SyntheticLM.fast_batch_at``, so
the host draws no Markov batch), each ``--decode`` item
``arch:batch:cache_len`` (float32 greedy decode).  ``arch`` is any
configuration the port builds (``zamba2-2.7b:2:256``,
``xlstm-350m:4:128``, ``seamless-m4t-medium:4:256``, ...);
``gemma2-100m`` is the example's; ``arch@L`` cuts it to L layers
(``llava-next-mistral-7b@8:2:256``).  An enc-dec configuration trains on
``frames`` (batch, seq, d) and a vision one on ``num_patches`` patches
before its ``seq`` tokens, both drawn from a seeded normal; their decode
is the tokens' alone (an enc-dec cache's ``enc_out`` stays zero, as in
``launch/serve.py``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _top(prof, key, n, by):
    rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, key))[:n]
    return [f"    {getattr(e, key) / 1e3:9.3f} ms {by}  {e.count:6d} calls  "
            f"{e.key[:90]}" for e in rows]


def _trace(torch, label, run, n):
    """``run`` n times untraced, then n times under
    ``chip_smoke.DeviceTrace`` (the card's kernels, copies and sets)."""
    from chip_smoke import DeviceTrace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with DeviceTrace(torch) as dev:
        for _ in range(n):
            run()
    busy = dev.busy_s * 1e3 / n
    print(f"[{label}] wall {1e3 * wall:.3f} ms a step; device busy "
          f"{busy:.3f} ms a step, {dev.n_kernels / n:.0f} kernels, copies "
          f"and sets a step; idle share {1 - busy / (1e3 * wall):.4f} of "
          f"the untraced wall", flush=True)
    print(f"[{label}] kernels by device time over {n} steps:")
    for name, us in sorted(dev.us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {name[:100]}")


def _profile(torch, label, run, n):
    """``run`` n times under ``torch.profiler``: the host's operators and
    CUDA API calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    print(f"[{label}] host operators by self CPU time over {n} steps:")
    print("\n".join(_top(prof, "self_cpu_time_total", 12, "self cpu")),
          flush=True)


def _train(torch, cfg, B, S):
    """A warm float32 train step of ``cfg`` at B x S: (run, cleanup)."""
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    box = [adamw.init_state(params), make_train_step(
        cfg, remat="none", compute_dtype=torch.float32,
        lr_kwargs=dict(base_lr=1e-4, warmup=1))]
    batch = {k: v.cuda() for k, v in
             SyntheticLM(cfg.vocab_size, S, B).fast_batch_at(0).items()}
    n = {"frames": S if cfg.family == "encdec" else 0,
         "patches": cfg.num_patches if cfg.frontend == "vision" else 0}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for key, rows in n.items():
        if rows:
            batch[key] = torch.randn((B, rows, cfg.d_model), device="cuda",
                                     generator=gen)

    def run():
        box[0], metrics = box[1](box[0], batch)
        float(metrics["loss"])
    return run, box.clear


def _decode(torch, cfg, B, L):
    """A warm float32 greedy decode step of ``cfg``, batch B, cache L."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model as model_lib
    box = [model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)),
        model_lib.init_cache(cfg, B, L, torch.float32, device="cuda")]
    serve = make_serve_step(cfg, compute_dtype=torch.float32)
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    pos = [0]

    def run():
        serve(box[0], box[1], tok, pos[0] % L)
        pos[0] += 1
    return run, box.clear


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", nargs="*",
                    default=["gemma2-100m:8:256", "gemma2-2b:2:256"])
    ap.add_argument("--decode", nargs="*", default=["gemma2-2b:4:128"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.examples.sgl_pruned_lm import example_config
    example_config()
    print(torch.cuda.get_device_name(0), flush=True)

    def config(arch):
        name, _, layers = arch.partition("@")
        cfg = get_config(name)
        return dataclasses.replace(cfg, num_layers=int(layers)) if layers \
            else cfg

    items = []
    for item in args.train:
        arch, B, S = item.split(":")
        items.append((f"train {arch} B {B} S {S}", _train,
                      (config(arch), int(B), int(S)), 3))
    for item in args.decode:
        arch, B, L = item.split(":")
        items.append((f"decode {arch} B {B} cache {L}", _decode,
                      (config(arch), int(B), int(L)), 12))
    # every CUPTI trace before the first torch.profiler run with CUDA
    # activity, which leaves its own timestamp source with CUPTI
    for measure in (_trace, _profile):
        for label, make, shape, n in items:
            run, cleanup = make(torch, *shape)
            for _ in range(2):
                run()
            measure(torch, label, run, n)
            cleanup()
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
