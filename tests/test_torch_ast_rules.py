"""The port's AST rules (``repro_torch.analysis.ast_rules``), the
counterpart of ``repro.analysis.ast_rules``, mirroring the AST tests of
``tests/test_analysis.py``: the tree matches the committed baseline, each
rule catches its seeded hazard, clean code yields nothing, and every rule
id of the five layers is registered.
"""
import os
import textwrap

from repro_torch import analysis
from repro_torch.analysis import ast_rules

_BASELINE = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                         "repro_torch", "analysis", "baseline.json")

_AST_BAD = textwrap.dedent("""
    import torch
    from repro_torch.core.cv import sgl_cv

    def captured_fn(X, v, n, spec):
        if v.sum() > 0:
            v = v * 2
        if spec.uniform:            # a static field: exempt
            v = v + 1
        s = float(v.sum())
        return X @ v + s

    def hot_driver(X, lams):
        out = []
        for lam in lams:
            res = sweep_sgl_core(X, lam)
            out.append(res.gap.item())
        torch.cuda.synchronize()
        return out

    def legacy_user(X, y):
        return sgl_cv(X, y, None, 1.0)
""")

_AST_CLEAN = textwrap.dedent("""
    import numpy as np

    def captured_ok(X, v, n, prox):
        for _ in range(n):
            v = prox(X.T @ (X @ v))
        if prox is None:
            return v
        return v

    def host_ok(grid):
        total = 0.0
        for lam in grid:
            total += float(lam)     # host floats, no device values
        return np.asarray(total)
""")


def test_ast_rules_match_baseline():
    """The AST findings on the tree equal the committed baseline's AST
    entries: no new hazard, no stale entry."""
    found = ast_rules.run()
    base = [e for e in analysis.load_baseline(_BASELINE)
            if e["rule"].startswith("ast/")]
    new, _, stale = analysis.diff_against_baseline(found, base)
    assert new == []
    assert stale == []


def test_baseline_entries_are_justified_and_known():
    for e in analysis.load_baseline(_BASELINE):
        assert e["rule"] in analysis.KNOWN_RULES
        assert e["justification"] and "TODO" not in e["justification"]


def test_seeded_ast_hazards_are_caught():
    found = ast_rules.lint_source(
        _AST_BAD, "core/fixture.py",
        captured={"core/fixture.py": {"captured_fn"}},
        hot={"core/fixture.py": {"hot_driver"}})
    rules = {f.rule for f in found}
    assert rules == {
        "ast/host-sync-in-traced",      # float() inside the captured fn
        "ast/tracer-branch",            # if v.sum() > 0 on a tensor param
        "ast/jit-dispatch-in-loop",     # sweep_sgl_core() per iteration
        "ast/host-sync-in-hot-loop",    # .item() on a device value
        "ast/block-until-ready",        # an unsanctioned synchronize
        "ast/deprecated-shim",          # sgl_cv() from non-shim code
    }
    branch = next(f for f in found if f.rule == "ast/tracer-branch")
    assert branch.detail.startswith("Python if on tensor parameter(s) v ")


def test_clean_ast_has_no_findings():
    found = ast_rules.lint_source(
        _AST_CLEAN, "core/fixture.py",
        captured={"core/fixture.py": {"captured_ok"}},
        hot={"core/fixture.py": {"host_ok"}})
    assert found == []


def test_sanctioned_reads_are_the_issue_s():
    """The baseline's sanctioned host reads: one a FISTA block (the solvers'
    ``bool(gap > threshold)``) and one a certified row (``solve_row``'s
    ``float(pval - dval)``)."""
    found = {(f.rule, f.location): f.detail for f in ast_rules.run()}
    for fn in ("fista_sgl", "fista_nn_lasso", "fista_sgl_graphed"):
        assert found[("ast/host-sync-in-hot-loop",
                      f"core/solver.py::{fn}")].startswith("bool()")
    for fn in ("sweep_sgl_core", "sweep_nn_core"):
        assert found[("ast/host-sync-in-hot-loop",
                      f"core/path_engine.py::{fn}")].startswith("float()")


def test_known_rules_cover_every_layer():
    """Every rule id the five layers' modules can emit is registered, and
    every registered id belongs to a layer."""
    import inspect
    import re
    from repro_torch.analysis import (compile_audit, kernel_check,
                                      resource_audit, trace_lint)
    emitted = set()
    for mod in (trace_lint, ast_rules, compile_audit, kernel_check,
                resource_audit):
        emitted |= set(re.findall(r'"((?:trace|ast|compile|kernels|'
                                  r'resource)/[a-z0-9-]+)"',
                                  inspect.getsource(mod)))
    assert emitted == set(analysis.KNOWN_RULES)
    assert {r.split("/")[0] for r in analysis.KNOWN_RULES} == {
        "trace", "ast", "compile", "kernels", "resource"}
    assert analysis.LAYERS == ("lint", "ast", "compile", "kernels",
                               "resource")


# -- the other layers' rules without a seeded test elsewhere (the compile
# and kernel layers' others are in tests/test_torch_analysis.py) -----------

def test_seeded_budget_excess_is_caught(monkeypatch):
    from repro_torch.analysis import compile_audit as cka
    from repro_torch.core.problem import Plan
    shape = cka.ProblemShape(N=100, p=500, G=50, max_size=10,
                             penalty="sgl", dtype="torch.float64")
    plan = Plan(n_lambdas=40, n_folds=4)
    assert cka.audit(shape, plan) == []
    monkeypatch.setattr(cka, "budget", lambda *a, **k: 1)
    found = cka.audit(shape, plan)
    assert found and {f.rule for f in found} == {"compile/budget-exceeded"}


def test_seeded_f64_gate_hole_is_caught(monkeypatch):
    """Screens that stop refusing float64 on the kernel route."""
    from repro_torch.analysis import kernel_check
    from repro_torch.core import dpc, screening
    monkeypatch.setattr(screening, "_require_f32_for_pallas",
                        lambda dtype: None)
    monkeypatch.setattr(dpc, "_require_f32_for_pallas",
                        lambda dtype: None, raising=False)
    found = kernel_check.f64_gate()
    assert found and {f.rule for f in found} == {"kernels/f64-gate"}


def test_seeded_wrapper_without_kernel_is_caught(monkeypatch):
    """A wrapper that computes its function without reaching its kernel."""
    from repro_torch.analysis import kernel_check
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "xtv", lambda X, v: ref.xtv_ref(X, v))
    found = kernel_check.run("cpu")
    assert [(f.rule, f.location) for f in found] == [
        ("kernels/no-kernel", "kernels.xtv")]
