#!/usr/bin/env python3
"""Measure the library workspaces that the resource model charges
(``launch.cost_analysis.LIBRARY_WORKSPACE_BYTES``): the bytes the caching
allocator hands cuBLAS, beyond the results, at

* the current stream's first product,
* a second stream's first product,
* the first bias GEMM (``addmm`` and ``linear`` with a bias: cuBLASLt),
* the first backward through a product, which the autograd engine runs on
  its device thread, with a cuBLAS handle of its own.

    python3 tools/audits_probe.py

Prints the card's name and power limit, torch's version,
``total_memory`` and one JSON object of the four readings.  Needs a card;
run it in a fresh process, before anything else has taken a workspace.
"""
from __future__ import annotations

import json
import subprocess
import sys


def workspaces(torch) -> dict:
    """Bytes ``memory_allocated`` grows by, beyond the results, at each of
    the four first uses above, in this order."""
    def grown(fn, results):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        keep = fn()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - m0 - results, keep

    n = 64
    out = n * n * 4
    a = torch.randn(n, n, device="cuda")
    bias = torch.randn(n, device="cuda")
    first, b = grown(lambda: a @ a, out)
    s = torch.cuda.Stream()

    def on_stream():
        with torch.cuda.stream(s):
            return a @ a
    stream, c = grown(on_stream, out)
    lt, d = grown(lambda: (torch.addmm(bias, a, a),
                           torch.nn.functional.linear(a, a, bias)), 2 * out)
    w = torch.randn(n, n, device="cuda", requires_grad=True)
    loss = (a @ w).sum()              # forward on this thread's handle
    backward, _ = grown(lambda: loss.backward(), out)    # w.grad
    del b, c, d
    return {"first_product": first, "new_stream": stream,
            "bias_gemm": lt, "autograd_thread": backward}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("audits_probe: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("torch", torch.__version__, torch.version.cuda)
    print("total_memory", torch.cuda.get_device_properties(0).total_memory)
    print(json.dumps({"library_workspaces": workspaces(torch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
