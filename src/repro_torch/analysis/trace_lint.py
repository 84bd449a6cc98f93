"""Operator-trace lint: run the engine's entry points under a dispatch mode
and check the ATen operators and kernel calls they issue (the counterpart
of ``repro.analysis.jaxpr_lint``).

The reference walks the jaxprs of its jitted entry points.  The port runs
eagerly, so the lint runs each entry once on the reference's
representative problem, every operator recorded by
``launch.cost_analysis.CostCounter`` with its operands' and results'
dtypes, shapes and devices, and every kernel call by its wrapper.  The
FISTA loop body (``core.solver._sgl_block`` and its nonnegative-Lasso twin
``_nn_block``) is marked while the lint runs by wrapping the two
functions; nothing on the card's path changes for it.

  * ``trace/f64-downcast``    (float64 traces) an operator whose float
    result is narrower than its widest float operand: an exactness path
    rounding through float32.
  * ``trace/kernel-on-f64``   (float64 traces) any of
    ``kernels.ops.KERNELS`` reached at all: the float32 kernels must be
    gated out (``path_engine._kernels_active``).
  * ``trace/upcast-in-loop``  (float32 traces) a float widening inside the
    FISTA block: hot-loop compute promoted to float64 (the classic culprit,
    float64 ``GroupSpec.weights`` leaking into the prox).
  * ``trace/transfer-in-loop`` ``aten._local_scalar_dense`` (a host read:
    ``.item()``, ``float()``, ``bool()``) or a copy across devices inside
    the FISTA block.
  * ``trace/accum-downcast``  a GEMM (``mm``, ``mv``, ``bmm``, ``addmm``,
    ``dot``, ``einsum``'s products, the ``xtv`` kernel) whose result is
    narrower than its widest float operand.
  * ``trace/full-gemm-count`` a sweep entry must issue exactly one p-column
    GEMM (or ``xtv`` call) per certified row: the Lemma-9 certification
    GEMV; more means the bucketing broke.

The host reads outside the block are the port's own synchronisation
points, one a block (``solver.fista_sgl``'s ``bool(gap > threshold)``) and
one a certified row (``path_engine.sweep_sgl_core``'s ``float(gap)``);
they are not findings of this layer (``ast_rules`` and the baseline
sanction them).

Entries are traced on the reference's problem, whose dimensions are all
distinct (N 8, p 20, p_bucket 12, G 5, g_bucket 4, n_max 6, L 4, K 2), so
"touches the full p" is unambiguous in the operands' shapes.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..launch.cost_analysis import GEMMS, CostCounter
from .findings import Finding

_N, _P, _PB, _GB, _L, _K = 8, 20, 12, 4, 4, 2
_SIZES = [3, 2, 5, 4, 6]          # G=5, n_max=6, sum=20
_MAX_ITER, _CHECK_EVERY = 60, 10

_HOST_READ = "aten._local_scalar_dense"
_COPIES = ("aten._to_copy", "aten.copy_", "aten._copy_from",
           "aten._copy_from_and_resize")


def _float_bits(dtype) -> int:
    return torch.finfo(dtype).bits if dtype.is_floating_point else 0


@contextlib.contextmanager
def marked_loop_body(counter: CostCounter):
    """Mark ``solver._sgl_block`` / ``_nn_block`` as the loop body while
    ``counter`` records."""
    from ..core import solver
    saved = {name: getattr(solver, name) for name in ("_sgl_block",
                                                      "_nn_block")}

    def wrap(fn):
        @functools.wraps(fn)
        def body(*args, **kw):
            with counter.in_loop():
                return fn(*args, **kw)
        return body

    for name, fn in saved.items():
        setattr(solver, name, wrap(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(solver, name, fn)


def lint_events(name: str, events, *, dtype: str, full_p=None,
                expect_full_gemms=None) -> list:
    """Check one entry's recorded operators (``CostCounter(record=True)``'s
    ``events``).  ``expect_full_gemms`` (with ``full_p``): the exact count
    of p-column GEMMs the entry may issue (per certified row times the rows
    run)."""
    findings, full_gemms = [], 0
    for ev in events:
        op = ev["op"]
        in_bits = max((_float_bits(d) for d in ev["in_dtypes"]), default=0)
        out_bits = max((_float_bits(d) for d in ev["out_dtypes"]),
                       default=0)
        short = op.split(".", 1)[1]
        gemm = ev["kind"] == "kernel" and short == "xtv" or \
            ev["kind"] == "aten" and short in GEMMS
        if dtype == "float64" and ev["kind"] == "kernel":
            findings.append(Finding(
                "trace/kernel-on-f64", "error", name,
                f"kernel {short} reached in the float64 trace of {name}: "
                f"the float32 kernels must be gated out"))
        if in_bits and out_bits and out_bits < in_bits:
            if gemm:
                findings.append(Finding(
                    "trace/accum-downcast", "error", name,
                    f"{op} accumulates float{in_bits} operands into "
                    f"float{out_bits} in {name}"))
            elif dtype == "float64":
                findings.append(Finding(
                    "trace/f64-downcast", "error", name,
                    f"{op}: float{in_bits} -> float{out_bits} in the f64 "
                    f"trace of {name} (in_loop={ev['in_loop']})"))
        if (dtype == "float32" and ev["in_loop"] and in_bits
                and out_bits > in_bits):
            findings.append(Finding(
                "trace/upcast-in-loop", "error", name,
                f"{op}: float{in_bits} -> float{out_bits} inside the FISTA "
                f"block of {name}: hot-loop compute promoted to f64"))
        if ev["in_loop"] and (op == _HOST_READ or (
                op in _COPIES
                and len(ev["in_devices"] | ev["out_devices"]) > 1)):
            findings.append(Finding(
                "trace/transfer-in-loop", "error", name,
                f"{op} inside the FISTA block of {name}: a host/device "
                f"round trip per iteration"))
        if gemm and full_p and any(
                full_p in shape for shape, dt in zip(ev["in_shapes"],
                                                     ev["in_dtypes"])
                if dt.is_floating_point):
            full_gemms += 1
    if expect_full_gemms is not None and full_gemms != expect_full_gemms:
        findings.append(Finding(
            "trace/full-gemm-count", "error", name,
            f"{full_gemms} full-X GEMMs in {name}; the engine contract is "
            f"exactly {expect_full_gemms} (one certification GEMV per "
            f"certified row)"))
    return findings


def trace(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), events)``: one run recorded, the loop body
    marked."""
    with CostCounter(record=True, memory=False) as counter:
        with marked_loop_body(counter):
            out = fn(*args, **kwargs)
    return out, counter.events


def lint_traceable(fn, *args, name: str, dtype: str, full_p=None,
                   expect_full_gemms=None) -> list:
    """Run ``fn(*args)`` recorded and lint it (the seeded tests' entry)."""
    _, events = trace(fn, *args)
    return lint_events(name, events, dtype=dtype, full_p=full_p,
                       expect_full_gemms=expect_full_gemms)


# ---------------------------------------------------------------------------
# the representative problem and the entries
# ---------------------------------------------------------------------------

def _rep(dtype, device):
    """The reference's tiny SGL/NN problem, on ``device``."""
    from ..core.groups import GroupSpec
    rng = np.random.default_rng(0)
    spec = GroupSpec.from_sizes(_SIZES, device=device)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    X = t(rng.standard_normal((_N, _P)))
    y = t(rng.standard_normal(_N))
    S = np.zeros(_P, dtype=bool)
    S[:10] = True                  # groups 0..2 (sizes 3+2+5)
    sub_spec, col_idx = spec.bucketed_subset(S, _PB, _GB)
    X_sub = torch.zeros((_N, _PB), dtype=dtype, device=device)
    X_sub[:, :len(col_idx)] = X[:, torch.as_tensor(col_idx, device=device)]
    return dict(spec=spec, sub_spec=sub_spec, X=X, y=y, X_sub=X_sub,
                lams=t(np.geomspace(1.0, 0.3, _L)),
                valid=np.ones(_L, dtype=bool), beta0=t(np.zeros(_PB)),
                lip=t(4.0), mu=t(rng.standard_normal(_P) * 0.1))


def _stackK(a):
    return torch.stack([a] * _K)


def _fold_rep(dtype, device):
    r = _rep(dtype, device)
    r["Y"] = _stackK(r["y"])
    r["masks"] = torch.ones((_K, _N), dtype=dtype, device=device)
    r["sub_specs"] = [r["sub_spec"]] * _K
    for k in ("X_sub", "lams", "beta0", "lip", "mu"):
        r[k + "s"] = _stackK(r[k])
    r["valids"] = np.stack([r["valid"]] * _K)
    r["gap_scales"] = np.ones(_K)
    return r


def _rows(out) -> int:
    """Rows a sweep ran (certified or the first failed one)."""
    return len(out[0])


def _entries():
    """(name, build(dtype, device) -> (fn, args, rows), full_p, per_row):
    ``rows(out)`` counts the certified rows the entry ran, so the expected
    full GEMMs are ``per_row * rows(out)``."""
    from ..core import cv as _cv
    from ..core import dpc as _dpc
    from ..core import screening as _scr
    from ..core import session as _sess
    from ..core.losses import LOGISTIC, get_loss
    from ..core.path_engine import (_kernels_active, sweep_nn_core,
                                    sweep_sgl_core)
    from ..core.solver import fista_nn_lasso, fista_sgl
    from ..launch.sgl_serve import _batch_lambda_max, _batch_refit

    def kern(dtype, device):
        return _kernels_active(True, dtype, device)

    def sweep_kw(dtype, device):
        return dict(max_iter=_MAX_ITER, check_every=_CHECK_EVERY,
                    use_kernels=kern(dtype, device))

    def sweep_sgl(dtype, device, centered, loss=None):
        r = _rep(dtype, device)
        kw = dict(sweep_kw(dtype, device), graphs={})
        if loss is not None:
            kw["loss"] = get_loss(loss)
        fn = functools.partial(sweep_sgl_core, **kw)
        args = [r["X"], r["X_sub"], r["y"], r["spec"], r["sub_spec"], 0.9,
                r["lip"], r["lams"], r["valid"], r["beta0"], 1e-9, 1.0]
        if centered:
            args.append(r["mu"])
        return fn, args, _rows

    def sweep_nn(dtype, device):
        r = _rep(dtype, device)
        fn = functools.partial(sweep_nn_core, **sweep_kw(dtype, device))
        return fn, [r["X"], r["X_sub"], r["y"], r["lip"], r["lams"],
                    r["valid"], r["beta0"], 1e-9, 1.0], _rows

    def fold_rows(out):
        return sum(len(m[0]) for m in out)

    def fold_sweep_sgl(dtype, device, centered):
        r = _fold_rep(dtype, device)
        fn = _cv._fold_sweep("sgl", None, _K, _MAX_ITER, _CHECK_EVERY,
                             kern(dtype, device), graphs={},
                             centered=centered)
        args = [r["X"], r["X_subs"], r["Y"], r["spec"], r["sub_specs"], 0.9,
                r["lips"], r["lamss"], r["valids"], r["beta0s"], 1e-9,
                r["gap_scales"]]
        if centered:
            args.append(r["mus"])
        return fn, args, fold_rows

    def fold_sweep_nn(dtype, device):
        r = _fold_rep(dtype, device)
        fn = _cv._fold_sweep("nn", None, _K, _MAX_ITER, _CHECK_EVERY,
                             kern(dtype, device), graphs=None)
        return fn, [r["X"], r["X_subs"], r["Y"], r["lips"], r["lamss"],
                    r["valids"], r["beta0s"], 1e-9, r["gap_scales"]], \
            fold_rows

    def ones(shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)

    def screen_folds_sgl(dtype, device, centered):
        r = _fold_rep(dtype, device)
        rem = _stackK(r["lams"])
        vecN, vecP = ones((_K, _N), dtype, device), ones((_K, _P), dtype,
                                                          device)
        vecG, o = ones((_K, len(_SIZES)), dtype, device), ones(_K, dtype,
                                                               device)
        fn = functools.partial(_cv._screen_folds_sgl, screen="gapsafe",
                               use_kernels=kern(dtype, device))
        return fn, [r["X"], r["Y"], r["spec"], 0.9, rem, o, 2.0 * o, vecN,
                    vecN, vecP, vecP, r["masks"], vecP, vecG, 0.0,
                    r["mus"] if centered else None], None

    def screen_folds_nn(dtype, device):
        r = _fold_rep(dtype, device)
        rem = _stackK(r["lams"])
        vecN, vecP = ones((_K, _N), dtype, device), ones((_K, _P), dtype,
                                                          device)
        o = ones(_K, dtype, device)
        fn = functools.partial(_cv._screen_folds_nn, screen="gapsafe",
                               use_kernels=kern(dtype, device))
        return fn, [r["X"], r["Y"], rem, o, 2.0 * o, vecN, vecN, vecP,
                    vecP, r["masks"], vecP, 0.0], None

    def grid_screen_sgl(dtype, device):
        r = _rep(dtype, device)
        vecP, vecG = ones(_P, dtype, device), ones(len(_SIZES), dtype,
                                                   device)
        fn = functools.partial(_scr.tlfre_screen_grid, safety=0.0,
                               use_kernels=kern(dtype, device))
        return fn, [r["X"], r["y"], r["spec"], 0.9, r["lams"], 1.0,
                    r["y"], r["y"], vecP, vecG], None

    def grid_screen_sgl_gapsafe(dtype, device):
        r = _rep(dtype, device)
        vecP, vecG = ones(_P, dtype, device), ones(len(_SIZES), dtype,
                                                   device)

        def both(spec, alpha, c_prev, col_n, gspec, y, rem, tb, resid, pen):
            radii = _scr.gap_safe_grid_radii(y, rem, tb, resid, pen)
            return _scr.gap_safe_screen_grid(
                spec, alpha, c_prev, radii, col_n, gspec,
                use_kernels=kern(dtype, device))

        return both, [r["spec"], 0.9, vecP, vecP, vecG, r["y"], r["lams"],
                      r["y"], r["y"], torch.tensor(1.0, dtype=dtype,
                                                   device=device)], None

    def grid_screen_nn(dtype, device):
        r = _rep(dtype, device)
        fn = functools.partial(_dpc.dpc_screen_grid, safety=0.0)
        return fn, [r["X"], r["y"], r["lams"], r["y"], r["y"],
                    ones(_P, dtype, device)], None

    def fold_duals_sgl(dtype, device):
        r = _fold_rep(dtype, device)
        betas = torch.zeros((_K, _P), dtype=dtype, device=device)
        return _sess._fold_duals_sgl, [r["X"], r["spec"], 0.9, r["Y"],
                                       r["masks"], betas, 1.0, None], None

    def fold_duals_nn(dtype, device):
        r = _fold_rep(dtype, device)
        betas = torch.zeros((_K, _P), dtype=dtype, device=device)
        return _sess._fold_duals_nn, [r["X"], r["Y"], r["masks"], betas,
                                      1.0], None

    def fista_sgl_entry(dtype, device, loss=None):
        r = _rep(dtype, device)
        kw = dict(max_iter=_MAX_ITER, check_every=_CHECK_EVERY, tol=1e-9)
        if loss is not None:
            kw["loss"] = get_loss(loss)
        fn = functools.partial(fista_sgl, **kw)
        return fn, [r["X_sub"], r["y"], r["sub_spec"], 0.5, 0.9, r["lip"],
                    r["beta0"]], None

    def grid_radii_logistic(dtype, device):
        r = _rep(dtype, device)
        fit = torch.zeros(_N, dtype=dtype, device=device)
        resid = LOGISTIC.residual(r["y"], fit)
        fn = functools.partial(_scr.gap_safe_grid_radii_loss, LOGISTIC)
        return fn, [r["y"], r["lams"], r["y"], fit, resid,
                    torch.tensor(1.0, dtype=dtype, device=device)], None

    def fista_nn_entry(dtype, device):
        r = _rep(dtype, device)
        fn = functools.partial(fista_nn_lasso, max_iter=_MAX_ITER,
                               check_every=_CHECK_EVERY, tol=1e-9)
        return fn, [r["X_sub"], r["y"], 0.5, r["lip"], r["beta0"]], None

    def serve_lambda_max(dtype, device, penalty):
        r = _rep(dtype, device)
        spec = r["spec"] if penalty == "sgl" else None
        fn = functools.partial(_batch_lambda_max, penalty=penalty)
        return fn, [r["X"], _stackK(r["y"]), spec, 0.9], None

    def serve_refit(dtype, device, penalty):
        r = _rep(dtype, device)
        lams = torch.tensor([0.5, 0.4], dtype=dtype, device=device)
        spec = r["spec"] if penalty == "sgl" else None
        fn = functools.partial(_batch_refit, penalty=penalty,
                               max_iter=_MAX_ITER, check_every=_CHECK_EVERY,
                               use_kernels=kern(dtype, device), graphs={})
        return fn, [r["X"], _stackK(r["y"]), lams, spec, 0.9, r["lip"],
                    1e-9], None

    return [
        ("sweep_sgl", lambda d, v: sweep_sgl(d, v, False), _P, 1),
        ("sweep_sgl_centered", lambda d, v: sweep_sgl(d, v, True), _P, 1),
        ("sweep_sgl_logistic",
         lambda d, v: sweep_sgl(d, v, False, loss="logistic"), _P, 1),
        ("sweep_nn", sweep_nn, _P, 1),
        ("fold_sweep_sgl", lambda d, v: fold_sweep_sgl(d, v, False), _P, 1),
        ("fold_sweep_sgl_centered",
         lambda d, v: fold_sweep_sgl(d, v, True), _P, 1),
        ("fold_sweep_nn", fold_sweep_nn, _P, 1),
        ("screen_folds_sgl", lambda d, v: screen_folds_sgl(d, v, False),
         _P, None),
        ("screen_folds_sgl_centered",
         lambda d, v: screen_folds_sgl(d, v, True), _P, None),
        ("screen_folds_nn", screen_folds_nn, _P, None),
        ("grid_screen_sgl", grid_screen_sgl, _P, None),
        ("grid_screen_sgl_gapsafe", grid_screen_sgl_gapsafe, _P, None),
        ("grid_screen_nn", grid_screen_nn, _P, None),
        ("fold_duals_sgl", fold_duals_sgl, _P, None),
        ("fold_duals_nn", fold_duals_nn, _P, None),
        ("fista_sgl", fista_sgl_entry, _P, None),
        ("fista_sgl_logistic",
         lambda d, v: fista_sgl_entry(d, v, loss="logistic"), _P, None),
        ("fista_nn", fista_nn_entry, _P, None),
        ("grid_radii_logistic", grid_radii_logistic, _P, None),
        ("serve_lambda_max_sgl",
         lambda d, v: serve_lambda_max(d, v, "sgl"), _P, None),
        ("serve_lambda_max_nn",
         lambda d, v: serve_lambda_max(d, v, "nn_lasso"), _P, None),
        ("serve_refit_sgl", lambda d, v: serve_refit(d, v, "sgl"), _P, None),
        ("serve_refit_nn", lambda d, v: serve_refit(d, v, "nn_lasso"),
         _P, None),
    ]


def entry_names() -> list:
    return [name for name, _, _, _ in _entries()]


def run(device=None, dtypes=("float32", "float64"), entries=None) -> list:
    """Run every registered entry at the given dtypes on ``device`` and lint
    it.  ``device`` None means the card (raises without one); "cpu" runs
    the kernels' plain versions.  float64 traces check the exactness
    contract (no narrowing, no kernel), float32 traces the hot-loop
    contract (no widening, no transfer)."""
    from ..core.groups import resolve_device
    device = resolve_device(device)
    findings = []
    only = set(entries) if entries is not None else None
    for name, build, full_p, per_row in _entries():
        if only is not None and name not in only:
            continue
        for dt in dtypes:
            dtype = getattr(torch, dt)
            fn, args, rows = build(dtype, device)
            out, events = trace(fn, *args)
            expect = None if per_row is None else per_row * rows(out)
            findings.extend(lint_events(
                f"{name}[{dt}]", events, dtype=dt, full_p=full_p,
                expect_full_gemms=expect))
    return findings
