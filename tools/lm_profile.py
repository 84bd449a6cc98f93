#!/usr/bin/env python3
"""Where the port's LM train step and decode step spend their time on the
card: wall per step without the profiler, then ``torch.profiler`` over a
few warm steps (device busy time per step, kernels per step, the kernels
and the host operators that take the most time).

    python3 tools/lm_profile.py [--train gemma2-100m:8:256 gemma2-2b:2:256]
                                [--decode gemma2-2b:4:128]

Each ``--train`` item is ``arch:batch:seq`` (float32, TF32 off, remat
none, the SGL prox off; iid tokens from ``SyntheticLM.fast_batch_at``, so
the host draws no Markov batch), each ``--decode`` item
``arch:batch:cache_len`` (float32 greedy decode).  ``gemma2-100m`` is the
example's configuration.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
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


def _profile(torch, label, run, n):
    """``run`` n times unprofiled, then n times under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import device_busy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) / n
    by_name, n_kernels, _, _ = device_busy(torch, prof)
    busy = sum(by_name.values()) / 1e3 / n
    print(f"[{label}] wall {1e3 * wall:.3f} ms a step ({1e3 * wall_p:.3f} "
          f"with the profiler); device busy {busy:.3f} ms a step, "
          f"{n_kernels / n:.0f} kernels, copies and sets a step; idle share "
          f"{1 - busy / (1e3 * wall):.4f} of the unprofiled wall", flush=True)
    print(f"[{label}] kernels by device time over {n} steps:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms  {name[:100]}")
    print(f"[{label}] host operators by self CPU time over {n} steps:")
    print("\n".join(_top(prof, "self_cpu_time_total", 12, "self cpu")),
          flush=True)


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
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.examples.sgl_pruned_lm import example_config
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    example_config()
    print(torch.cuda.get_device_name(0), flush=True)

    for item in args.train:
        arch, B, S = item.split(":")
        cfg, B, S = get_config(arch), int(B), int(S)
        params = model_lib.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        box = [adamw.init_state(params)]
        step = make_train_step(cfg, remat="none",
                               compute_dtype=torch.float32,
                               lr_kwargs=dict(base_lr=1e-4, warmup=1))
        batch = {k: v.cuda() for k, v in
                 SyntheticLM(cfg.vocab_size, S, B).fast_batch_at(0).items()}

        def run():
            box[0], metrics = step(box[0], batch)
            float(metrics["loss"])
        for _ in range(2):
            run()
        _profile(torch, f"train {arch} B {B} S {S}", run, 3)
        del box, params, step
        torch.cuda.empty_cache()

    for item in args.decode:
        arch, B, L = item.split(":")
        cfg, B, L = get_config(arch), int(B), int(L)
        params = model_lib.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        caches = model_lib.init_cache(cfg, B, L, torch.float32, device="cuda")
        serve = make_serve_step(cfg, compute_dtype=torch.float32)
        tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
        pos = [0]

        def run():
            serve(params, caches, tok, pos[0] % L)
            pos[0] += 1
        for _ in range(2):
            run()
        _profile(torch, f"decode {arch} B {B} cache {L}", run, 12)
        del params, caches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
