"""repro_torch.analysis: the audits the port holds itself to (the
counterpart of ``repro.analysis``'s compile and Pallas layers).

* ``compile_audit``: the O(log p) universe of sweep-shape keys and of
  captured CUDA graphs a Problem/Plan can make, and the check that a
  session paid only predicted ones.
* ``kernel_check``: mask coverage of the five kernel wrappers under 1e30
  poison, and the float64 gate of the grid screens.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis --compile --kernels \\
        [--device cpu]    # default cuda; raises without a card

The reference's jaxpr lint, AST rules and XLA resource audit read JAX
traces and have no counterpart here.
"""
from __future__ import annotations

from .findings import (Finding, diff_against_baseline, format_report,
                       load_baseline, write_baseline)

LAYERS = ("compile", "kernels")

#: every rule id the layers can emit
KNOWN_RULES = (
    "compile/budget-exceeded", "compile/unpredicted-key",
    "compile/unpredicted-graph",
    "kernels/mask-coverage", "kernels/f64-gate",
)


def run_layers(layers=LAYERS, device=None) -> list:
    """Run the requested layers; returns all findings.  ``device`` is
    where the kernel layer runs the wrappers ("cuda" launches the
    kernels, "cpu" runs their plain versions); None means the card and
    raises without CUDA."""
    findings = []
    if "compile" in layers:
        from . import compile_audit
        findings.extend(compile_audit.run())
    if "kernels" in layers:
        from . import kernel_check
        findings.extend(kernel_check.run(device))
    return findings


__all__ = ["Finding", "KNOWN_RULES", "LAYERS", "diff_against_baseline",
           "format_report", "load_baseline", "run_layers",
           "write_baseline"]
