"""CLI of the port's audits: prints the report and exits 1 on any error
finding.

    PYTHONPATH=src python -m repro_torch.analysis --compile --kernels
    PYTHONPATH=src python -m repro_torch.analysis --kernels --device cpu

``--device`` defaults to ``cuda``; without a card that raises.
"""
from __future__ import annotations

import argparse
import sys

from ..launch.steps import resolve_cli_device
from . import LAYERS, format_report, run_layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's compile-key and kernel audits")
    ap.add_argument("--compile", action="store_true",
                    help="the compile-key and CUDA-graph universes")
    ap.add_argument("--kernels", action="store_true",
                    help="mask coverage of the kernel wrappers and the "
                         "float64 gate")
    ap.add_argument("--device", default="cuda",
                    help="where the kernel layer runs the wrappers "
                         "(default cuda: launches the kernels, and raises "
                         "without a card; cpu: their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    layers = tuple(name for name in LAYERS if getattr(args, name)) or LAYERS
    findings = run_layers(layers, device=dev)
    print(f"repro_torch.analysis: layers={','.join(layers)} "
          f"device={args.device}")
    print(format_report(findings, [], []))
    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
