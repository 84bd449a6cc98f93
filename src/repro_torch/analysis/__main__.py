"""CLI of the port's audits.

Exit status 0 iff every finding is covered by the baseline; a new finding
exits 1 (the gate).  Stale baseline entries warn, unless the entry cites a
rule that no longer exists (``KNOWN_RULES``), which exits 1 (rewrite the
file with ``--prune-baseline``).

    PYTHONPATH=src python -m repro_torch.analysis --all \\
        --baseline src/repro_torch/analysis/baseline.json \\
        --budgets src/repro_torch/analysis/budgets.json [--device cpu]
    PYTHONPATH=src python -m repro_torch.analysis --layer ast --layer lint
    PYTHONPATH=src python -m repro_torch.analysis --compile --kernels
    PYTHONPATH=src python -m repro_torch.analysis --all --json ...
    PYTHONPATH=src python -m repro_torch.analysis --prune-baseline PATH
    PYTHONPATH=src python -m repro_torch.analysis --capacity \\
        [--plan n_folds=5 ...] [--hbm-gb 80]

``--device`` defaults to the card and raises without one.  The capacity
planner prices the card's route on fake tensors and needs none (on a torch
built without CUDA the fake tensors are the CPU's, pricing the same route);
``--device cpu`` prices the CPU's route.  Its default budget is the card's
memory.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..launch.steps import resolve_cli_device
from . import (KNOWN_RULES, LAYERS, diff_against_baseline, format_report,
               load_baseline, run_layers, write_baseline)


def _finding_lines(new, matched, stale):
    """One JSON object a finding: rule, severity, location, detail and its
    baseline status."""
    for status, group in (("new", sorted(new)),
                          ("baselined", sorted(matched))):
        for f in group:
            yield {"rule": f.rule, "severity": f.severity,
                   "location": f.location, "detail": f.detail,
                   "baseline": status}
    for e in stale:
        yield {"rule": e["rule"], "severity": "warning",
               "location": e["location"],
               "detail": "stale baseline entry (matched nothing)",
               "baseline": "stale"}


def _parse_plan_overrides(pairs):
    """['n_folds=5', 'chunk_cap=128'] -> Plan(**overrides)."""
    from ..core.problem import Plan
    kw = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--plan expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            kw[k] = json.loads(v)
        except json.JSONDecodeError:
            kw[k] = v
    return Plan(**kw)


def _run_capacity(args) -> int:
    from ..launch import cost_analysis as ca
    from . import resource_audit
    plan = _parse_plan_overrides(args.plan)
    hbm = int(args.hbm_gb * 1e9) if args.hbm_gb else ca.device_hbm_bytes()
    rows = resource_audit.capacity_table(
        plan, hbm_bytes=hbm, N=args.capacity_n, survivors=args.survivors,
        feature_shards=args.shards, device=args.device)
    if args.as_json:
        for r in rows:
            print(json.dumps(r, sort_keys=True))
        return 0
    dev = ca.trace_device(args.device)
    print(f"capacity planner: max p on one {ca.DEVICE_NAME} "
          f"({hbm / 1e9:.2f} GB, N={args.capacity_n}, screened solve "
          f"bucket <= {args.survivors} features, sharded column at "
          f"{args.shards} feature shards; the card's route traced on fake "
          f"{dev.type} tensors)")
    print("penalty,dtype,mode,max_p_screened,max_p_unscreened,"
          "max_p_sharded")
    for r in rows:
        sharded = r["max_p_sharded"]
        print(f"{r['penalty']},{r['dtype']},{r['mode']},"
              f"{r['max_p_screened']},{r['max_p_unscreened']},"
              f"{'-' if sharded is None else sharded}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's audits (operator-trace lint, AST, "
                    "compile-key, kernel and resource layers)")
    ap.add_argument("--all", action="store_true", help="run every layer")
    ap.add_argument("--layer", action="append", choices=LAYERS, default=[],
                    help="run one layer (repeatable)")
    for name in LAYERS:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"run the {name} layer")
    ap.add_argument("--device", default=None,
                    help="where the lint and the kernel layer run, and "
                         "what the resource layer and --capacity price "
                         "(default: the card, and the layers raise without "
                         "one; cpu: the CPU's route and the kernels' plain "
                         "versions)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON of intentional findings; any "
                         "finding not in it fails the run")
    ap.add_argument("--budgets", default=None,
                    help="resource budget JSON for the resource layer")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current findings as a baseline "
                         "skeleton (justifications to fill in), exit 0")
    ap.add_argument("--write-budgets", default=None, metavar="PATH",
                    help="write the current cost cards as a budget file "
                         "(25%% headroom), exit 0")
    ap.add_argument("--prune-baseline", default=None, metavar="PATH",
                    help="rewrite PATH keeping only the entries that still "
                         "match a finding (sorted), exit 0")
    ap.add_argument("--capacity", action="store_true",
                    help="invert the resource model: the largest p a card "
                         "holds for the Plan (see --plan)")
    ap.add_argument("--plan", action="append", default=[], metavar="K=V",
                    help="Plan field override for --capacity (repeatable)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="memory budget for --capacity (default: the "
                         "card's)")
    ap.add_argument("--survivors", type=int, default=16384,
                    help="screened solve-bucket cap for --capacity")
    ap.add_argument("--capacity-n", type=int, default=1000,
                    help="sample count N for --capacity")
    ap.add_argument("--shards", type=int, default=8,
                    help="feature-shard count for --capacity's sharded "
                         "column and --write-budgets' feature cards")
    ap.add_argument("--verbose", action="store_true",
                    help="list baselined findings too")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON object a finding")
    args = ap.parse_args(argv)

    if args.capacity:
        return _run_capacity(args)

    dev = resolve_cli_device(args.device or "cuda")
    if args.write_budgets:
        from . import resource_audit
        cards = resource_audit.audit_cards(device=dev)
        cards.extend(resource_audit.feature_audit_cards(
            feature_shards=args.shards, device=dev))
        resource_audit.write_budgets(cards, args.write_budgets)
        print(f"wrote {len(cards)} budget configs to {args.write_budgets}")
        return 0

    picked = list(args.layer) + [n for n in LAYERS if getattr(args, n)]
    layers = LAYERS if (args.all or not picked) else \
        tuple(n for n in LAYERS if n in picked)
    findings = run_layers(layers, device=dev, budgets=args.budgets)

    if args.write_baseline:
        write_baseline(findings, args.write_baseline)
        print(f"wrote {len({f.key for f in findings})} baseline entries "
              f"to {args.write_baseline}")
        return 0

    if args.prune_baseline:
        baseline = load_baseline(args.prune_baseline)
        _, matched, stale = diff_against_baseline(findings, baseline)
        kept = [e for e in baseline
                if (e["rule"], e["location"]) in {f.key for f in matched}]
        kept.sort(key=lambda e: (e["rule"], e["location"]))
        with open(args.prune_baseline, "w") as fh:
            json.dump({"findings": kept}, fh, indent=2)
            fh.write("\n")
        print(f"pruned {len(stale)} stale entr"
              f"{'y' if len(stale) == 1 else 'ies'}; kept {len(kept)} in "
              f"{args.prune_baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else []
    new, matched, stale = diff_against_baseline(findings, baseline)
    dead = [e for e in stale if e["rule"] not in KNOWN_RULES]
    if args.as_json:
        for line in _finding_lines(new, matched, stale):
            print(json.dumps(line, sort_keys=True))
    else:
        print(f"repro_torch.analysis: layers={','.join(layers)} "
              f"device={dev}")
        print(format_report(new, matched, stale, verbose=args.verbose))
        if dead:
            print(f"DEAD baseline entries ({len(dead)}): rule no longer in "
                  f"the registry; run --prune-baseline:")
            for e in dead:
                print(f"  {e['rule']} @ {e['location']}")
    return 1 if (new or dead) else 0


if __name__ == "__main__":
    sys.exit(main())
