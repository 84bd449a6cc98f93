"""CLI of the port's audits: prints the report and exits 1 on any error
finding.

    PYTHONPATH=src python -m repro_torch.analysis --compile --kernels
    PYTHONPATH=src python -m repro_torch.analysis --kernels --device cuda
"""
from __future__ import annotations

import argparse
import sys

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
    ap.add_argument("--device", default="cpu",
                    help="where the kernel layer runs the wrappers "
                         "(default cpu: their plain versions; cuda "
                         "launches the kernels)")
    args = ap.parse_args(argv)
    layers = tuple(name for name in LAYERS if getattr(args, name)) or LAYERS
    findings = run_layers(layers, device=args.device)
    print(f"repro_torch.analysis: layers={','.join(layers)} "
          f"device={args.device}")
    print(format_report(findings, [], []))
    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
