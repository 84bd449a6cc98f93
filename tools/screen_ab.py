#!/usr/bin/env python3
"""Time the TLFre grid screen of one source tree on the card, so that two
trees can be compared in turns within one run on one card.

    python3 tools/screen_ab.py [--src DIR] [--label NAME]

``DIR`` is the root of a checkout of this repository (default: the one
that holds this script); its ``src/repro_torch`` is imported and its
kernels are built into its own ``build/``.  At the paper's Synthetic 1
(Table 1: N = 250, p = 10 000, 1000 groups of 10, 100 lambdas, whose first
screen covers 128 grid rows) it prints one JSON line with:

- ``kernel_ms``: the ``screen_norms`` kernel alone on its own inputs: the
  padded (128 * 1000, 10) copy for a tree whose kernel takes that copy, or
  the screen GEMM's output C (128, 10 000) for one that reads C through
  ``pad_index``;
- ``step_ms``: ``_grid_group_stats(spec, C, True)``, the group-statistics
  step as the path runs it (for the first kind of tree: gather, mask,
  kernel and ``sqrt``);
- the warm float32 path (``SGLSession.path``, calls 2-4 of one session):
  wall, ``screen_time`` and ``solve_time`` of each call, its FISTA
  iterations and solve us per iteration, its ``n_pallas_screens`` and its
  ``screen_norms`` launches.

Device times come from a CUDA graph of 20 calls, the median of 10 replays
timed by CUDA events.  The card's name and power limit lead the output.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def time_ms(torch, fn, reps=10, inner=20):
    """Device ms of one call: ``inner`` calls captured in one CUDA graph,
    the median over ``reps`` replays divided by ``inner``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("screen_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = args.src.resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch.core as T
    from repro_torch.core.screening import _grid_group_stats
    from repro_torch.data_synth import synthetic_sgl
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    L, G, n = 128, 1000, 10
    spec = T.GroupSpec.uniform_groups(G, n, device="cuda")
    C = torch.randn(L, G * n, device="cuda") * 2
    if len(inspect.signature(screen_norms_cuda).parameters) == 2:
        c_pad = torch.where(spec.pad_mask[None], C[:, spec.pad_index],
                            0.0).reshape(L * G, n).contiguous()
        kernel = lambda: screen_norms_cuda(c_pad, spec.pad_mask)  # noqa: E731
        form = "padded copy"
    else:
        kernel = lambda: screen_norms_cuda(C, spec.pad_index,  # noqa: E731
                                           spec.pad_mask)
        form = "C through pad_index"
    kernel_ms = time_ms(torch, kernel)
    step_ms = time_ms(torch, lambda: _grid_group_stats(spec, C, True))

    X, y, _ = synthetic_sgl(1, N=250, G=G, n=n, gamma1=0.1, gamma2=0.1,
                            seed=1)
    plan = T.Plan(alpha=1.0, n_lambdas=100, tol=1e-6, safety=1e-6,
                  max_iter=6000, check_every=50)
    sess = T.SGLSession(T.Problem.sgl(X, y, [n] * G))
    sess.path(plan)                                    # cold: builds, captures
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = sess.path(plan)
        torch.cuda.synchronize()
        warm.append(dict(wall_s=time.perf_counter() - t0,
                         screen_s=res.screen_time,
                         solve_s=res.solve_time,
                         fista_iters=res.stats.fista_iters,
                         solve_us_per_iter=1e6 * res.solve_time
                         / max(res.stats.fista_iters, 1),
                         n_pallas_screens=res.stats.n_pallas_screens,
                         screen_norms_launches=ops.launch_counts()[
                             "screen_norms"]))
    print(json.dumps(dict(label=args.label or str(root), kernel_form=form,
                          kernel_ms=kernel_ms, step_ms=step_ms,
                          warm_path=warm)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
