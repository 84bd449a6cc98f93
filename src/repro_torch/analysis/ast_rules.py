"""AST rules: host-synchronisation hazards in the port's Python (the
counterpart of ``repro.analysis.ast_rules``).

The trace lint proves properties of what runs; this layer lints the Python
that decides what is captured into a CUDA graph and where the host waits
for the card.  Registry-driven, to stay precise: a small set of captured
functions, of hot host paths and of device-producing calls, so a host read
of data that is on the host already (fold bookkeeping, grid cursors) never
fires.

Rules (one finding per (rule, file::qualname); the detail aggregates line
numbers, so unrelated edits do not churn the baseline):

  * ``ast/host-sync-in-traced``  ``.item()``, ``float`` / ``int`` /
    ``bool`` of a value, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``np.asarray`` or ``torch.cuda.synchronize`` inside a function captured
    into a CUDA graph (``solver._sgl_block``, ``_SGLBlockGraph._block``)
    or called from one: a capture error waiting to happen (a read during
    capture fails), and a hidden round trip where it runs eagerly.
  * ``ast/tracer-branch``        a Python ``if`` on a tensor parameter of
    such a function (``is None`` tests and attribute reads of static fields,
    such as ``spec.uniform``, are exempt): the branch is frozen into the
    graph at capture.
  * ``ast/jit-dispatch-in-loop``  a device-producing call (a sweep, a
    screen, a solve) inside a ``for`` / ``while`` of a hot host path: each
    iteration pays its launches and, after it, a host read.  The engine
    drivers' one sweep a segment and one solve a row are baselined by
    design; a new entry means a batching regression.
  * ``ast/host-sync-in-hot-loop`` taint analysis: values returned by the
    device-producing calls (the sweeps, the screens, the solvers) are on
    the card; a host read of them inside a ``for`` / ``while`` of a hot
    host path forces a wait per iteration.  The engine's one read a FISTA
    block and one a certified row are baselined by design.
  * ``ast/block-until-ready``    ``synchronize`` outside the sanctioned sites
    (``path_engine._sync``, ``launch.steps.sync_device``).
  * ``ast/deprecated-shim``      (warning) calls to the legacy entry points
    (``sgl_cv`` / ``nn_lasso_cv`` / ``stability_selection``) from non-shim
    code.

"""
from __future__ import annotations

import ast
import os

from .findings import Finding

# ---------------------------------------------------------------------------
# Registries: the precision of every rule comes from here.
# ---------------------------------------------------------------------------

#: functions captured into CUDA graphs, and what they call on the way
#: (top-level name or method name); also the reference's padded kernel
#: entry points, held to the same rules as the wrapper a graph captures
CAPTURED_FUNCTIONS = {
    "core/solver.py": {"_sgl_block", "_block", "_sgl_gap", "_nn_block"},
    "core/prox.py": {"sgl_prox", "nn_lasso_prox"},
    "core/fenchel.py": {"sgl_penalty", "shrink"},
    "core/lambda_max.py": {"dual_scaling_sgl"},
    "kernels/ops.py": {"sgl_prox", "screen_norms", "screen_norms_batched",
                       "sgl_prox_padded"},
}

#: host driver paths where a per-iteration wait is the hazard
HOT_HOST_PATHS = {
    "core/path_engine.py": {"sgl_path_batched", "nn_lasso_path_batched",
                            "_certified_rows", "sweep_sgl_core",
                            "sweep_nn_core"},
    "core/solver.py": {"fista_sgl", "fista_nn_lasso", "fista_sgl_graphed"},
    "core/cv.py": {"screen", "harvest", "make_launch", "run",
                   "sgl_fold_paths", "nn_fold_paths"},
    "core/session.py": {"path", "cv", "refine", "stability",
                        "_fold_state_at"},
    "launch/sgl_serve.py": {"_run_batch", "drain", "_batch_refit"},
}

#: functions nested in a hot path that its loop calls once an iteration
#: (``_certified_rows`` calls ``solve_row`` once a row): their host reads
#: are per-iteration reads of the enclosing path
HOT_LOOP_BODIES = {
    "core/path_engine.py": {"solve_row"},
}

#: calls whose results are on the card
DEVICE_CALLABLES = {
    "sweep_sgl_core", "sweep_nn_core", "sweep_sgl_core_feat",
    "sweep_nn_core_feat", "certify_sgl_row", "certify_nn_row",
    "solve_sgl", "solve_nn_lasso", "fista_sgl", "fista_nn_lasso",
    "fista_sgl_graphed", "solve", "runner", "_sgl_gap", "_nn_gap",
    "tlfre_screen_grid", "gap_safe_screen_grid", "dpc_screen_grid",
    "_screen_folds_sgl", "_screen_folds_nn", "lambda_max_sgl",
    "lambda_max_nn", "spectral_norm", "_spectral_norms_f",
    "_fold_duals_sgl", "_fold_duals_nn", "_batch_lambda_max",
}

#: attributes whose read yields device tensors (the launch-output handoff)
DEVICE_ATTRS = {"outputs", "gap"}

#: parameters that select code, not data (branching on them is fine)
STATIC_PARAM_NAMES = {
    "n", "loss", "prox", "self", "check_every", "max_iter", "use_kernels",
    "screen", "penalty", "kind", "mesh", "graphs", "certify",
}

#: attributes of a tensor-carrying parameter that are static fields
STATIC_ATTRS = {"uniform", "num_groups", "num_features", "max_size",
                "feature_weights", "gamma", "name", "shape", "dtype",
                "device", "ndim"}

#: predicates that read a tensor's device or type, never its data
STATIC_PREDICATES = {"_on_cpu", "is_fake", "isinstance"}

#: (file, enclosing function) pairs where a synchronize is sanctioned: the
#: timing barriers every driver goes through
SYNC_ALLOWLIST = {
    ("core/path_engine.py", "_sync"),
    ("launch/steps.py", "sync_device"),
}

DEPRECATED_SHIMS = {"sgl_cv", "nn_lasso_cv", "stability_selection"}
# the shims' own home and the facades that re-export them
SHIM_FILES = {"core/cv.py", "core/path.py", "api.py", "core/__init__.py"}

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_NP = {"asarray", "array", "ascontiguousarray"}


def _call_name(node: ast.Call):
    """Trailing identifier of the called expression (Name or Attribute)."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _call_root(node: ast.Call):
    f = node.func
    while isinstance(f, ast.Attribute):
        f = f.value
    return f.id if isinstance(f, ast.Name) else None


def _is_sync_call(node: ast.Call) -> bool:
    name = _call_name(node)
    if name in ("float", "int", "bool") and isinstance(node.func, ast.Name) \
            and node.args:
        return True
    if name in _SYNC_METHODS and isinstance(node.func, ast.Attribute):
        return True
    if name in _SYNC_NP and _call_root(node) in ("np", "numpy"):
        return True
    return name == "synchronize"


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assigned_names(target) -> list:
    """Flat Name ids bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for elt in target.elts:
            out.extend(_assigned_names(elt))
        return out
    return []


class _TopFns(ast.NodeVisitor):
    """Top-level functions and class methods, with qualnames."""

    def __init__(self):
        self.fns = []           # (qualname, bare name, node)

    def visit_ClassDef(self, node):
        for child in node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.fns.append((f"{node.name}.{child.name}", child.name,
                                 child))

    def visit_FunctionDef(self, node):
        self.fns.append((node.name, node.name, node))

    visit_AsyncFunctionDef = visit_FunctionDef


def _walk_with_loops(body, in_loop=False):
    """(node, in_loop) over statements and expressions, tracking For / While
    nesting (comprehensions do not count: they run over host data)."""
    for node in body:
        yield node, in_loop
        child_loop = in_loop or isinstance(node, (ast.For, ast.While))
        yield from _walk_with_loops(list(ast.iter_child_nodes(node)),
                                    child_loop)


def _agg(findings_map, rule, severity, loc, line, what):
    entry = findings_map.setdefault((rule, loc), [severity, []])
    entry[1].append((line, what))


def _emit(findings_map):
    out = []
    for (rule, loc), (severity, hits) in sorted(findings_map.items()):
        lines = sorted({ln for ln, _ in hits})
        whats = sorted({w for _, w in hits})
        out.append(Finding(
            rule, severity, loc,
            f"{', '.join(whats)} at line(s) {', '.join(map(str, lines))}"))
    return out


def _dynamic_names(test, dyn: set) -> set:
    """Parameters a branch test reads as data: neither an ``is None``
    probe nor a read of a static field (``spec.uniform``)."""
    exempt_nodes = set()
    for node in ast.walk(test):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.Is, ast.IsNot))):
            exempt_nodes.update(id(n) for n in ast.walk(node.left))
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            exempt_nodes.update(id(n) for n in ast.walk(node.value))
        if isinstance(node, ast.Call) and \
                _call_name(node) in STATIC_PREDICATES:
            exempt_nodes.update(id(n) for n in ast.walk(node))
    return {n.id for n in ast.walk(test)
            if isinstance(n, ast.Name) and id(n) not in exempt_nodes} & dyn


def _lint_captured(qual, node, relpath, fmap):
    params = {a.arg for a in (node.args.posonlyargs + node.args.args
                              + node.args.kwonlyargs)}
    dyn = params - STATIC_PARAM_NAMES
    loc = f"{relpath}::{qual}"
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _is_sync_call(sub):
            _agg(fmap, "ast/host-sync-in-traced", "error", loc, sub.lineno,
                 f"{_call_name(sub)}() inside a captured function")
        elif isinstance(sub, ast.If):
            offenders = _dynamic_names(sub.test, dyn)
            if offenders:
                _agg(fmap, "ast/tracer-branch", "error", loc, sub.lineno,
                     f"Python if on tensor parameter(s) "
                     f"{'/'.join(sorted(offenders))}")


def _loop_walk(node, relpath):
    """(node, in_loop) over a hot function's body; the bodies of its
    nested ``HOT_LOOP_BODIES`` count as inside a loop."""
    bodies = HOT_LOOP_BODIES.get(relpath, set())
    for sub, in_loop in _walk_with_loops(node.body):
        if isinstance(sub, ast.FunctionDef) and sub.name in bodies:
            yield from _walk_with_loops(sub.body, True)
        yield sub, in_loop


def _lint_hot(qual, node, relpath, fmap):
    loc = f"{relpath}::{qual}"
    # taint pass: names bound from device calls or device attributes, then
    # propagated through slicing, unpacking and arithmetic
    tainted: set = set()
    for _ in range(3):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                targets, v = sub.targets, sub.value
            elif isinstance(sub, (ast.For, ast.comprehension)):
                targets, v = [sub.target], sub.iter
            else:
                continue
            src = False
            if isinstance(v, ast.Call) and _call_name(v) in DEVICE_CALLABLES:
                src = True
            elif isinstance(v, ast.Attribute) and v.attr in DEVICE_ATTRS:
                src = True
            elif _names_in(v) & tainted and not any(
                    isinstance(c, ast.Call) and _is_sync_call(c)
                    for c in ast.walk(v)):
                # arithmetic of device values stays on the device; a value
                # that passes through a host read lands on the host
                src = True
            if src:
                for t in targets:
                    tainted.update(_assigned_names(t))
    for sub, in_loop in _loop_walk(node, relpath):
        if not isinstance(sub, ast.Call) or not in_loop:
            continue
        name = _call_name(sub)
        if name in DEVICE_CALLABLES:
            _agg(fmap, "ast/jit-dispatch-in-loop", "error", loc,
                 sub.lineno, f"{name}() launched per loop iteration")
        if not _is_sync_call(sub):
            continue
        operands = list(sub.args) + [kw.value for kw in sub.keywords]
        if isinstance(sub.func, ast.Attribute):
            operands.append(sub.func.value)     # x.item(), x.cpu()
        arg_names, direct = set(), False
        for a in operands:
            arg_names |= _names_in(a)
            direct = direct or any(
                (isinstance(c, ast.Call)
                 and _call_name(c) in DEVICE_CALLABLES)
                or (isinstance(c, ast.Attribute) and c.attr in DEVICE_ATTRS)
                for c in ast.walk(a))
        if (arg_names & tainted) or direct:
            _agg(fmap, "ast/host-sync-in-hot-loop", "error", loc,
                 sub.lineno, f"{name}() waits for the card per loop "
                 f"iteration")


def lint_source(src: str, relpath: str, *, captured=None, hot=None,
                allow_sync=None, shim_files=None) -> list:
    """Lint one file's source.  Registry overrides exist for the seeded
    fixture tests."""
    captured = CAPTURED_FUNCTIONS if captured is None else captured
    hot = HOT_HOST_PATHS if hot is None else hot
    allow_sync = SYNC_ALLOWLIST if allow_sync is None else allow_sync
    shim_files = SHIM_FILES if shim_files is None else shim_files
    tree = ast.parse(src)
    top = _TopFns()
    top.visit(tree)
    fmap: dict = {}

    for qual, bare, node in top.fns:
        if bare in captured.get(relpath, set()):
            _lint_captured(qual, node, relpath, fmap)
        if bare in hot.get(relpath, set()):
            _lint_hot(qual, node, relpath, fmap)

    def enclosing(lineno):
        best = "<module>"
        for qual, _, node in top.fns:
            if node.lineno <= lineno <= (node.end_lineno or node.lineno):
                best = qual
        return best

    for sub in ast.walk(tree):
        if not isinstance(sub, ast.Call):
            continue
        name = _call_name(sub)
        if name == "synchronize":
            fn = enclosing(sub.lineno)
            if (relpath, fn.split(".")[-1]) not in allow_sync:
                _agg(fmap, "ast/block-until-ready", "error",
                     f"{relpath}::{fn}", sub.lineno,
                     "synchronize outside the sanctioned sites")
        elif name in DEPRECATED_SHIMS and relpath not in shim_files:
            fn = enclosing(sub.lineno)
            _agg(fmap, "ast/deprecated-shim", "warning",
                 f"{relpath}::{fn}", sub.lineno,
                 f"call to legacy shim {name}()")
    return _emit(fmap)


def run(root=None) -> list:
    """Lint every file under ``src/repro_torch`` (this analyzer's package
    excluded)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = []
    for dirpath, _, files in os.walk(root):
        if os.path.basename(dirpath) == "analysis":
            continue
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            relpath = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as fh:
                src = fh.read()
            findings.extend(lint_source(src, relpath))
    return findings
