"""The port's operator-trace lint (``repro_torch.analysis.trace_lint``), the
counterpart of ``repro.analysis.jaxpr_lint``, mirroring the jaxpr tests of
``tests/test_analysis.py``.

The repository is clean on the reference's 23 entries at float32 and
float64, on the CPU (the kernels' plain versions; the f32 traces take the
kernel route, as the engines do for float32), and each ``trace/`` rule
catches one seeded hazard while clean code yields nothing.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.analysis import trace_lint
from repro_torch.core import solver
from repro_torch.core.groups import GroupSpec
from repro_torch.kernels import ops as kops

CPU = "cpu"


def _rules(found):
    return sorted({f.rule for f in found})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_repo_entries_clean(dtype):
    """float64: no narrowing, no kernel, exactly one full-X GEMM per
    certified row; float32: no widening or host read in the FISTA block."""
    assert trace_lint.run(CPU, dtypes=(dtype,)) == []


def test_entries_are_the_references():
    from repro.analysis import jaxpr_lint
    assert trace_lint.entry_names() == jaxpr_lint.entry_names()


def test_full_gemm_count_counts_certified_rows():
    """On the entry's problem with its true Lipschitz bound and a loose
    tolerance, the sweep certifies several rows, one p-column GEMV each
    (through ``xtv`` on the f32 kernel route)."""
    for dtype, kind in ((torch.float64, "aten"), (torch.float32, "kernel")):
        name, build, full_p, _ = next(e for e in trace_lint._entries()
                                      if e[0] == "sweep_sgl")
        fn, args, rows = build(dtype, torch.device(CPU))
        args[6] = torch.linalg.matrix_norm(args[1], 2) ** 2
        args[10] = 1e-6
        out, events = trace_lint.trace(fn, *args)
        assert rows(out) >= 2
        full = [e for e in events if e["kind"] == kind and any(
            full_p in s for s in e["in_shapes"])
            and e["op"].split(".", 1)[1] in ("mv", "xtv")]
        assert len(full) == rows(out)
        assert trace_lint.lint_events(name, events, dtype=str(dtype)[6:],
                                      full_p=full_p,
                                      expect_full_gemms=rows(out)) == []


def test_seeded_f64_downcast_is_caught():
    def bad(x):
        return torch.sum(x.to(torch.float32))

    found = trace_lint.lint_traceable(bad, torch.ones(5, dtype=torch.float64),
                                      name="seeded", dtype="float64")
    assert _rules(found) == ["trace/f64-downcast"]


def test_seeded_kernel_on_f64_is_caught():
    X = torch.ones((4, 3), dtype=torch.float64)
    v = torch.ones(4, dtype=torch.float64)
    found = trace_lint.lint_traceable(
        lambda X, v: kops.xtv(X, v).to(torch.float64), X, v, name="seeded",
        dtype="float64")
    assert "trace/kernel-on-f64" in _rules(found)


def test_seeded_accum_downcast_is_caught():
    """The ``xtv`` kernel accumulates into float32: handed float64 operands
    it narrows them (under the float32 contract only this rule applies)."""
    X = torch.ones((4, 3), dtype=torch.float64)
    v = torch.ones(4, dtype=torch.float64)
    found = trace_lint.lint_traceable(kops.xtv, X, v, name="seeded",
                                      dtype="float32")
    assert _rules(found) == ["trace/accum-downcast"]


def _fista_args(dtype):
    rng = np.random.default_rng(0)
    spec = GroupSpec.from_sizes([3, 2, 5], device=CPU)
    X = torch.as_tensor(rng.standard_normal((8, 10)), dtype=dtype)
    y = torch.as_tensor(rng.standard_normal(8), dtype=dtype)
    return X, y, spec, 0.5, 0.9, torch.tensor(4.0, dtype=dtype), \
        torch.zeros(10, dtype=dtype)


def test_seeded_upcast_in_loss_is_caught():
    """A loss whose gradient computes in float64 promotes the float32 FISTA
    block (the reference's ``_LeakyLogistic`` fixture); the honest loss is
    clean on the same trace."""
    from repro_torch.core.losses import LogisticLoss

    class _Leaky(LogisticLoss):
        def grad(self, y, u):
            return (torch.sigmoid(u.to(torch.float64))
                    - y.to(torch.float64)).to(u.dtype)

    args = _fista_args(torch.float32)
    kw = dict(max_iter=40, check_every=10, tol=1e-6)
    found = trace_lint.lint_traceable(
        functools.partial(solver.fista_sgl, loss=_Leaky(), **kw), *args,
        name="seeded-loss", dtype="float32")
    assert "trace/upcast-in-loop" in _rules(found)
    clean = trace_lint.lint_traceable(
        functools.partial(solver.fista_sgl, loss=LogisticLoss(), **kw),
        *args, name="clean-loss", dtype="float32")
    assert clean == []


def test_seeded_transfer_in_loop_is_caught():
    """A prox that reads a value on the host inside the FISTA block."""
    from repro_torch.core.prox import sgl_prox
    X, y, spec, lam, alpha, lip, beta0 = _fista_args(torch.float32)

    def leaky(v, a, b):
        return sgl_prox(spec, v, a, b) * float(v.abs().max() > 0)

    found = trace_lint.lint_traceable(
        functools.partial(solver.fista_sgl, prox=leaky, max_iter=20,
                          check_every=10, tol=1e-9),
        X, y, spec, lam, alpha, lip, beta0, name="seeded", dtype="float32")
    assert _rules(found) == ["trace/transfer-in-loop"]


def test_seeded_extra_full_gemm_is_caught():
    """A certification that issues two p-column GEMVs a row."""
    X = torch.ones((8, 20), dtype=torch.float64)
    rho = torch.ones(8, dtype=torch.float64)

    def two_per_row(X, rho):
        return [(X.T @ rho) + (X.T @ (2 * rho)) for _ in range(3)]

    found = trace_lint.lint_traceable(two_per_row, X, rho, name="seeded",
                                      dtype="float64", full_p=20,
                                      expect_full_gemms=3)
    assert _rules(found) == ["trace/full-gemm-count"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_clean_loop_has_no_findings(dtype):
    args = _fista_args(getattr(torch, dtype))
    fn = functools.partial(solver.fista_sgl, max_iter=30, check_every=10,
                           tol=1e-9)
    assert trace_lint.lint_traceable(fn, *args, name="clean",
                                     dtype=dtype) == []


def test_loop_marker_restores_the_solver():
    before = (solver._sgl_block, solver._nn_block)
    trace_lint.trace(lambda: None)
    assert (solver._sgl_block, solver._nn_block) == before
