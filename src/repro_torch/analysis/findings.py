"""Structured findings and baseline diffing for the port's audits (a copy
of ``repro.analysis.findings``, so that nothing here imports the JAX
package).

Every audit (``compile_audit``, ``kernel_check``) reports ``Finding``
records.  A finding is identified by ``(rule, location)``; ``location`` is
a stable identifier (entry point, kernel name; never a line number) and
``detail`` carries the human-readable specifics.  The baseline functions
diff findings against a JSON list of intentional ones, each with a
one-line justification.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation.

    ``rule``: dotted rule id, e.g. ``compile/unpredicted-key``.
    ``severity``: "error" | "warning".
    ``location``: stable identity — diffed against the baseline.
    ``detail``: human-readable specifics (free to include line numbers).
    """
    rule: str
    severity: str
    location: str
    detail: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    @property
    def key(self) -> tuple:
        return (self.rule, self.location)


def load_baseline(path: str) -> list:
    """Baseline entries: ``[{rule, location, justification}, ...]``."""
    with open(path) as f:
        data = json.load(f)
    entries = data["findings"] if isinstance(data, dict) else data
    for e in entries:
        if "rule" not in e or "location" not in e:
            raise ValueError(f"baseline entry missing rule/location: {e}")
    return entries


def write_baseline(findings: Iterable[Finding], path: str,
                   justifications: Optional[dict] = None) -> None:
    """Serialise the given findings as a baseline skeleton (one entry per
    distinct (rule, location); justification defaults to TODO)."""
    justifications = justifications or {}
    seen = {}
    for f in sorted(findings):
        if f.key in seen:
            continue
        seen[f.key] = {
            "rule": f.rule,
            "location": f.location,
            "justification": justifications.get(
                f.key, "TODO: justify or fix"),
        }
    with open(path, "w") as fh:
        json.dump({"findings": list(seen.values())}, fh, indent=2)
        fh.write("\n")


def diff_against_baseline(findings: Iterable[Finding], baseline: list):
    """(new, matched, stale): findings not covered by the baseline, findings
    covered, and baseline entries matching nothing (candidates for
    removal)."""
    base_keys = {(e["rule"], e["location"]) for e in baseline}
    found_keys = set()
    new, matched = [], []
    for f in findings:
        found_keys.add(f.key)
        (matched if f.key in base_keys else new).append(f)
    stale = [e for e in baseline
             if (e["rule"], e["location"]) not in found_keys]
    return new, matched, stale


def format_report(new, matched, stale, *, verbose: bool = False) -> str:
    lines = []
    if new:
        lines.append(f"NEW findings ({len(new)}) — not in baseline:")
        for f in sorted(new):
            lines.append(f"  [{f.severity}] {f.rule} @ {f.location}")
            lines.append(f"      {f.detail}")
    if matched and verbose:
        lines.append(f"baselined findings ({len(matched)}):")
        for f in sorted(matched):
            lines.append(f"  [{f.severity}] {f.rule} @ {f.location}")
    elif matched:
        lines.append(f"baselined findings: {len(matched)} "
                     f"(--verbose to list)")
    if stale:
        lines.append(f"STALE baseline entries ({len(stale)}) — matched "
                     f"nothing; remove them:")
        for e in stale:
            lines.append(f"  {e['rule']} @ {e['location']}")
    if not (new or matched or stale):
        lines.append("clean: no findings")
    return "\n".join(lines)
