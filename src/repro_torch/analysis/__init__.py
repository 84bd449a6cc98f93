"""repro_torch.analysis: the static audits the port holds itself to (the
counterpart of ``repro.analysis``).

Five layers prove before or around a run what the engines' counters only
observe:

  1. ``trace_lint``    (``lint``): dtype purity, host reads in the FISTA
     block, kernels on float64, one full-X GEMM a certified row, in the
     ATen operators of every entry point (a dispatch mode over real runs
     on the reference's tiny problem).
  2. ``ast_rules``     (``ast``): host synchronisation in captured
     functions and hot host loops, synchronize outside the sanctioned
     sites, legacy shims.
  3. ``compile_audit`` (``compile``): the O(log p) universe of sweep-shape
     keys and of captured CUDA graphs, and the check that a session paid
     only predicted ones.
  4. ``kernel_check``  (``kernels``): mask coverage of the five kernel
     wrappers under 1e30 poison, the float64 gate, no wrapper without its
     kernel.
  5. ``resource_audit`` (``resource``): per-key cost cards on fake tensors
     (peak, loop-expanded FLOPs and bytes, per-launch transfer, the
     captured graphs' statics, collective plans on fake process groups,
     shard layout), gated on ``budgets.json``; the capacity planner.

Every reference rule has a counterpart here but one:
``pallas/block-divisibility`` reads the ``BlockSpec`` of a traced
``pallas_call``, and a CUDA kernel has none (``kernel_check``).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis --all \\
        --baseline src/repro_torch/analysis/baseline.json \\
        --budgets src/repro_torch/analysis/budgets.json [--device cpu]
    PYTHONPATH=src python -m repro_torch.analysis --capacity

``--device`` defaults to the card and raises without one; the resource
layer's fake traces and ``--capacity`` need none.
"""
from __future__ import annotations

from .findings import (Finding, diff_against_baseline, format_report,
                       load_baseline, write_baseline)

LAYERS = ("lint", "ast", "compile", "kernels", "resource")

#: every rule id a layer can emit: a baseline entry citing a rule outside
#: it is rot and fails the CLI
KNOWN_RULES = (
    "trace/f64-downcast", "trace/kernel-on-f64", "trace/upcast-in-loop",
    "trace/transfer-in-loop", "trace/accum-downcast",
    "trace/full-gemm-count",
    "ast/host-sync-in-traced", "ast/tracer-branch",
    "ast/host-sync-in-hot-loop", "ast/jit-dispatch-in-loop",
    "ast/block-until-ready", "ast/deprecated-shim",
    "compile/budget-exceeded", "compile/unpredicted-key",
    "compile/unpredicted-graph",
    "kernels/mask-coverage", "kernels/f64-gate", "kernels/no-kernel",
    "resource/hbm-over-budget", "resource/unexpected-collective",
    "resource/non-divisible-shard",
    "resource/transfer-in-segment-regression",
)


def run_layers(layers=LAYERS, device=None, budgets=None) -> list:
    """Run the requested layers; returns all findings.  ``device`` is where
    the lint runs its entries and the kernel layer its wrappers ("cuda"
    launches the kernels, "cpu" runs their plain versions) and what the
    resource layer prices (the card's route on fake CUDA tensors, or the
    CPU's); None means the card and raises without CUDA.  ``budgets`` (a
    path) feeds the resource layer."""
    from ..core.groups import resolve_device
    device = resolve_device(device)
    findings = []
    if "lint" in layers:
        from . import trace_lint
        findings.extend(trace_lint.run(device))
    if "ast" in layers:
        from . import ast_rules
        findings.extend(ast_rules.run())
    if "compile" in layers:
        from . import compile_audit
        findings.extend(compile_audit.run())
    if "kernels" in layers:
        from . import kernel_check
        findings.extend(kernel_check.run(device))
    if "resource" in layers:
        from . import resource_audit
        findings.extend(resource_audit.run(budgets=budgets, device=device))
    return findings


__all__ = ["Finding", "KNOWN_RULES", "LAYERS", "diff_against_baseline",
           "format_report", "load_baseline", "run_layers",
           "write_baseline"]
