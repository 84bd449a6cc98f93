"""Resource audit: per-compile-key cost cards, session envelopes and the
capacity planner (the counterpart of ``repro.analysis.resource_audit``).

``compile_audit`` proves which sweep shapes a Problem/Plan can pay; this
layer prices them without running a solve.  The reference traces its sweep
cores to jaxprs on abstract values.  The port runs eagerly and reads each
gap on the host (once a FISTA block, once a certified row), which a fake
tensor cannot give, so a whole sweep cannot run on fake tensors.  Instead
the pieces a sweep is made of run at the key's shapes on fake tensors
(``torch._subclasses.FakeTensorMode``: no data, no memory) under
``launch.cost_analysis.CostCounter``, in the order the engine runs them and
holding what the engine holds:

  * the setup (``X^T y``, lambda_max, column and group norms, ``||X||``);
  * one grid screen over the remaining grid;
  * the launch's operands (the bucketed ``X_sub``, its spec, its norm);
  * one ``check_every`` block with its gap, as captured on the card
    (``solver._SGLBlockGraph``: its static copies are the key's graph) or
    eager;
  * one certification row (``path_engine.certify_sgl_row``).

The FLOPs and bytes of a block and a row are then expanded by the key's
``max_iter / check_every`` blocks a row and its rows, as the reference's
``walk_cost`` expands a ``while`` (an upper envelope: a solve stops at its
tolerance).  The peak of live bytes over the pieces, plus the rows' kept
outputs, is the key's transient (``excess_bytes``).

  * **Residents and transfers** per launch, field by field, as the
    reference's ``_args_for_key`` (``resident_fields`` /
    ``transfer_fields``).  The port's spec holds int64 indices, float64
    group weights and two more fields (``pad_uncovered``,
    ``seg_lengths``).
  * **Graphs: the port's own term.**  Each captured ``_SGLBlockGraph``
    keeps static copies of ``X_sub``, ``y`` and the spec for the session's
    life, and its capture took cuBLAS's workspaces anew inside the graph's
    private pool, which the graph holds too.  So a session's envelope is
    its residents, plus the graphs it captured
    (``compile_audit.predict_graph_keys``), plus its largest transient,
    plus the library workspaces of the streams it runs on
    (``session_envelope``).
  * **Collective plans** are traced on fake process groups
    (``launch.mesh.fake_world``), in a process of their own: the fold sweep
    fires none (each rank runs its members' rows alone), the feature shards
    all-reduce only (the reference's psum-only rule).
  * **Shard layout**: ``verify_shard_layout``, the divisibility rule of
    ``distributed.sharding.divisible``.

Cards diff against ``src/repro_torch/analysis/budgets.json``:
``resource/hbm-over-budget`` gates every card's peak against the card's
memory.  ``capacity_max_p`` / ``capacity_table`` invert the model (the
peak is affine in p for a fixed bucket signature) for the largest p that
fits.

``device`` everywhere: None prices the card's route (the kernels and the
graphed FISTA block for float32) on fake tensors of ``trace_device()``;
"cuda" the same on fake CUDA tensors; "cpu" the CPU's route (no kernel, no
graph).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

import torch

from ..launch import cost_analysis as ca
from .compile_audit import (ProblemShape, _grid_len, _pow2_ceil,
                            chunk_lengths, feature_buckets, group_buckets)
from .findings import Finding

RULES = (
    "resource/hbm-over-budget",
    "resource/unexpected-collective",
    "resource/non-divisible-shard",
    "resource/transfer-in-segment-regression",
)

DEFAULT_BUDGETS = {
    # the card's memory (``launch.cost_analysis.device_hbm_bytes``)
    "device_hbm_bytes": ca.DEVICE_HBM_BYTES,
    # collectives allowed inside sweep bodies (none: folds are independent)
    "allowed_collectives": [],
    # per-configuration budgets, keyed by card label:
    #   {"peak_bytes": ..., "transfer_bytes": ...}
    "configs": {},
}

_I64, _F64 = 8, 8
#: power-method steps the pricing runs: a step frees the last one's
#: temporaries, so the transient does not grow with the steps (their FLOPs
#: are counted at this many)
_POWER = 2


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KeyDims:
    """The dimensions a compile key names (``compile_audit``'s tuples)."""
    kind: str                 # sgl | nn | sgl-folds | nn-folds | *-feat
    Ka: int                   # members of a launch (1 on a path)
    S: int                    # feature shards (0 unsharded)
    N: int
    p: int
    G: int                    # 0 for the nonnegative Lasso
    dtype: torch.dtype
    max_iter: int
    check_every: int
    kernels: bool
    p_b: int
    g_b: int
    max_size: int
    len2: int
    loss: str
    centered: bool

    @property
    def sgl(self) -> bool:
        return self.kind.startswith("sgl")

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()


def _dtype(s) -> torch.dtype:
    return getattr(torch, str(s).split(".")[-1])


def key_dims(key: tuple) -> KeyDims:
    """Parse one of the port's compile keys."""
    kind = key[0]
    if kind == "sgl":
        (_, N, p, G, dt, mi, ce, kern, p_b, g_b, ms, len2, loss) = key
        return KeyDims(kind, 1, 0, N, p, G, _dtype(dt), mi, ce, kern, p_b,
                       g_b, ms, len2, loss, False)
    if kind == "nn":
        (_, N, p, dt, mi, ce, kern, p_b, len2, loss) = key
        return KeyDims(kind, 1, 0, N, p, 0, _dtype(dt), mi, ce, kern, p_b,
                       0, 1, len2, loss, False)
    if kind == "sgl-folds":
        (_, Ka, N, p, G, dt, mi, ce, _mesh, p_b, g_b, ms, len2, centered,
         kern, loss) = key
        return KeyDims(kind, Ka, 0, N, p, G, _dtype(dt), mi, ce, kern, p_b,
                       g_b, ms, len2, loss, bool(centered))
    if kind == "nn-folds":
        (_, Ka, N, p, dt, mi, ce, _mesh, p_b, len2, kern, loss) = key
        return KeyDims(kind, Ka, 0, N, p, 0, _dtype(dt), mi, ce, kern, p_b,
                       0, 1, len2, loss, False)
    if kind == "sgl-feat":
        (_, S, N, p, G, dt, mi, ce, _grp, kern, p_b, g_b, ms, len2,
         loss) = key
        return KeyDims(kind, 1, S, N, p, G, _dtype(dt), mi, ce, kern, p_b,
                       g_b, ms, len2, loss, False)
    if kind == "nn-feat":
        (_, S, N, p, dt, mi, ce, _grp, kern, p_b, len2, loss) = key
        return KeyDims(kind, 1, S, N, p, 0, _dtype(dt), mi, ce, kern, p_b,
                       0, 1, len2, loss, False)
    raise ValueError(f"unknown compile-key kind {kind!r}")


def _route(device):
    """(fake trace device, whether the card's route is priced)."""
    if device is None:
        return ca.trace_device(None), True
    dev = ca.trace_device(device)
    return dev, dev.type == "cuda"


# ---------------------------------------------------------------------------
# residents and transfers, field by field (the reference's _args_for_key)
# ---------------------------------------------------------------------------

def spec_fields(G: int, p: int, n_max: int, lead: int = 1,
                prefix: str = "spec") -> dict:
    """Bytes of each tensor field of the port's GroupSpec (``lead``
    stacked copies)."""
    n_max = max(int(n_max), 1)
    return {f"{prefix}.sizes": lead * G * _I64,
            f"{prefix}.starts": lead * G * _I64,
            f"{prefix}.group_ids": lead * p * _I64,
            f"{prefix}.weights": lead * G * _F64,
            f"{prefix}.pad_index": lead * G * n_max * _I64,
            f"{prefix}.pad_mask": lead * G * n_max,
            f"{prefix}.pad_uncovered": lead * p,
            f"{prefix}.seg_lengths": lead * G * _I64}


def _shard_dims(d: KeyDims) -> tuple:
    """(width of one feature block, its groups) of a ``*-feat`` key: the
    static envelope of the partitioner (``shard_width_bound``)."""
    from ..distributed.feature_shard import effective_shards, \
        shard_width_bound
    units = d.G if d.sgl else d.p
    S_eff = effective_shards(units, d.S)
    return (shard_width_bound(d.p, units, S_eff, d.max_size),
            max(units // S_eff, 1))


def resident_fields(key: tuple) -> dict:
    """The operands that live on the card for the session (X, y or the
    cohort's Y, the parent spec, the fold means), by field."""
    d = key_dims(key)
    isz = d.itemsize
    if d.kind.endswith("-feat"):
        p_sh, G_sh = _shard_dims(d)
        out = {"X": d.N * p_sh * isz, "y": d.N * isz}
        if d.sgl:
            out.update(spec_fields(G_sh, p_sh, d.max_size))
        return out
    rows = d.Ka if d.kind.endswith("-folds") else 1
    out = {"X": d.N * d.p * isz, "y": rows * d.N * isz}
    if d.sgl:
        out.update(spec_fields(d.G, d.p, d.max_size))
    if d.centered:
        out["mus"] = d.Ka * d.p * isz
    return out


def transfer_fields(key: tuple) -> dict:
    """What a launch builds for its sweep (the bucketed designs, their
    specs, the lambda chunk, the valid flags, the warm starts), by field."""
    d = key_dims(key)
    isz, Ka = d.itemsize, d.Ka
    out = {"X_sub": Ka * d.N * d.p_b * isz}
    if d.sgl:
        out.update(spec_fields(d.g_b, d.p_b, d.max_size, Ka, "sub_spec"))
    out.update({"lipschitz": Ka * isz, "lams": Ka * d.len2 * isz,
                "valid": Ka * d.len2, "beta0": Ka * d.p_b * isz})
    if d.kind.endswith("-folds"):
        out["gap_scales"] = Ka * isz
    return out


def _fields_total(fields: dict) -> int:
    return int(sum(fields.values()))


# ---------------------------------------------------------------------------
# fake operands
# ---------------------------------------------------------------------------

def fake_spec(G: int, p: int, n_max: int, dev, uniform: bool = False):
    """A GroupSpec of fake tensors (call inside ``cost_analysis.fake_mode``):
    the shapes and dtypes of a real one, no data."""
    from ..core.groups import GroupSpec
    n_max = max(int(n_max), 1)

    def e(shape, dt):
        return torch.empty(shape, dtype=dt, device=dev)

    return GroupSpec(
        sizes=e(G, torch.int64), starts=e(G, torch.int64),
        group_ids=e(p, torch.int64), weights=e(G, torch.float64),
        pad_index=e((G, n_max), torch.int64),
        pad_mask=e((G, n_max), torch.bool), num_groups=G, num_features=p,
        max_size=n_max, uniform=bool(uniform), pad_uncovered=e(p, torch.bool),
        seg_lengths=e(G, torch.int64))


class _Pieces:
    """The counter's running peak and FLOPs at each piece's end."""

    def __init__(self, counter):
        self.c = counter
        self.marks = {}
        self._flops = 0.0
        self._bytes = 0.0

    def mark(self, name):
        self.marks[name] = {"flops": self.c.flops - self._flops,
                            "bytes": self.c.bytes_moved - self._bytes,
                            "peak": self.c.peak}
        self._flops, self._bytes = self.c.flops, self.c.bytes_moved


def _solve_block(d: KeyDims, X_sub, y, sub_spec, card, loss, pieces):
    """One FISTA iteration, then the block's gap, at the key's shapes, as the
    route runs them: ``_SGLBlockGraph`` on the card's float32 kernel route
    (its statics, allocated here, are the key's graph), else the eager
    loop.  A block's transient is one iteration's (each frees the last);
    its FLOPs and bytes are ``check_every`` iterations' and the gap's.
    Returns (outputs kept for the row, graph statics or None)."""
    from ..core import solver
    from ..core.path_engine import _padded_prox
    dt, dev = X_sub.dtype, X_sub.device
    lam = torch.ones((), dtype=dt, device=dev)
    lip = torch.ones((), dtype=dt, device=dev)
    beta0 = torch.zeros(d.p_b, dtype=dt, device=dev)
    tk0 = torch.ones((), dtype=dt, device=dev)
    t_step = 1.0 / lip
    if not d.sgl:
        beta, z, tk = solver._nn_block(X_sub, y, t_step, t_step * lam, beta0,
                                       beta0, tk0, 1)
        pieces.mark("iteration")
        pval, dval, theta = solver._nn_gap(X_sub, y, lam, beta)
        pieces.mark("gap")
        return (beta, theta, pval - dval), None
    t_l1 = (t_step * lam).reshape(1)
    t_group = t_step * lam * 0.5 * sub_spec.weights.to(dt)
    if card and d.kernels and dt == torch.float32:
        graph = solver._SGLBlockGraph(X_sub, y, sub_spec, lam, 1, loss)
        graph.bind(X_sub, y, sub_spec, lam, 0.5, t_step, t_l1, t_group,
                   beta0)
        pieces.mark("graph")
        beta, z, tk = solver._sgl_block(
            graph.X, graph.y, graph.t_step, graph.t_l1, graph.t_group,
            graph._prox, graph.beta, graph.z, graph.tk, 1, loss)
        pieces.mark("iteration")
        pval, dval, theta = solver._sgl_gap(graph.X, graph.y, graph.spec,
                                            graph.lam, graph.alpha, beta,
                                            loss)
        pieces.mark("gap")
        return (beta.clone(), theta.clone(), (pval - dval).clone()), graph
    prox = _padded_prox(sub_spec) if d.kernels else None
    if prox is None:
        from ..core.prox import sgl_prox
        prox = lambda v, a, b: sgl_prox(sub_spec, v, a, b)  # noqa: E731
    beta, z, tk = solver._sgl_block(X_sub, y, t_step, t_l1, t_group, prox,
                                    beta0, beta0, tk0, 1, loss)
    pieces.mark("iteration")
    pval, dval, theta = solver._sgl_gap(X_sub, y, sub_spec, lam, 0.5, beta,
                                        loss)
    pieces.mark("gap")
    return (beta, theta, pval - dval), None


def _certify_row(d: KeyDims, X, X_sub, y, spec, sub_spec, beta, mu, loss):
    from ..core import path_engine as pe
    lam = torch.ones((), dtype=X_sub.dtype, device=X_sub.device)
    if d.sgl:
        cert = pe._sgl_certifier(X, spec, 0.5, mu, d.kernels, beta.dtype)
        return pe.certify_sgl_row(X_sub, y, sub_spec, 0.5, lam, beta, cert,
                                  loss)
    cert = pe._nn_certifier(X, d.kernels, beta.dtype)
    return pe.certify_nn_row(X_sub, y, lam, beta, cert)


def _setup(d: KeyDims, X, y, spec, loss):
    """The path's setup at the key's shapes, with the power method for the
    group norms (the Frobenius bound's transient is smaller); returns what
    it keeps."""
    from ..core.dpc import lambda_max_nn
    from ..core.lambda_max import lambda_max_sgl
    from ..core.linalg import (column_norms, group_spectral_norms,
                               spectral_norm)
    r0 = loss.residual_at_zero(y)
    xty = X.T @ r0
    col_n = column_norms(X)
    if d.sgl:
        lam_max, g_star = lambda_max_sgl(spec, xty, 0.5)
        gspec = group_spectral_norms(X, spec, iters=_POWER)
    else:
        lam_max, g_star, gspec = lambda_max_nn(xty)[0], None, None
    L_full = spectral_norm(X, iters=_POWER) ** 2
    # what the segment loop keeps beside them: the dual anchor, its
    # correlation and the Gap-Safe warm start
    theta_bar = r0 / lam_max
    c_prev = xty / lam_max
    beta_dev = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    return dict(r0=r0, xty=xty, col_n=col_n, gspec=gspec, g_star=g_star,
                lam_max=lam_max, L_full=L_full, theta_bar=theta_bar,
                c_prev=c_prev, beta_dev=beta_dev)


def _screen(d: KeyDims, X, y, spec, st, L: int, loss):
    """One grid screen of the path over ``L`` lambdas; returns the kept
    sets (which the engine reads on the host)."""
    from ..core.dpc import dpc_screen_grid, normal_vector_nn
    from ..core.estimation import normal_vector_sgl
    from ..core.screening import (gap_safe_grid_radii_loss,
                                  gap_safe_screen_grid, tlfre_screen_grid)
    dt, dev = X.dtype, X.device
    rem = torch.ones(L, dtype=dt, device=dev)
    theta_bar = st["r0"] / 1.0
    if d.sgl and loss.name != "squared":
        fit = X @ torch.zeros(d.p, dtype=dt, device=dev)
        radii = gap_safe_grid_radii_loss(
            loss, y, rem, theta_bar, fit, loss.residual(y, fit),
            torch.ones((), dtype=dt, device=dev))
        return gap_safe_screen_grid(spec, 0.5, st["xty"], radii, st["col_n"],
                                    st["gspec"], use_kernels=d.kernels)[1]
    if d.sgl:
        n_vec = normal_vector_sgl(X, y, spec, 1.0, 1.0, theta_bar,
                                  st["g_star"])
        return tlfre_screen_grid(X, y, spec, 0.5, rem, 1.0, theta_bar, n_vec,
                                 st["col_n"], st["gspec"], safety=1e-6,
                                 use_kernels=d.kernels)[1]
    n_vec = normal_vector_nn(X, y, 0.5, 1.0, theta_bar, st["xty"])
    return dpc_screen_grid(X, y, rem, theta_bar, n_vec, st["col_n"])[0]


def _fold_setup(d: KeyDims, X, Y, masks, spec, mus):
    """The fold engine's per-fold geometry at the key's shapes."""
    from ..core.fenchel import shrink
    from ..core.lambda_max import lambda_max_sgl
    from ..core.linalg import group_spectral_norms
    col2_f = masks @ (X * X)
    xty_f = Y @ X
    if mus is not None:
        xty_f = xty_f - torch.sum(Y, dim=1)[:, None] * mus
    col_n_f = torch.sqrt(col2_f)
    del col2_f
    if d.sgl:
        lm = [lambda_max_sgl(spec, xty_f[k], 0.5) for k in range(d.Ka)]
        gspec_f = torch.stack([group_spectral_norms(
            masks[k][:, None] * (X - mus[k][None, :] if mus is not None
                                 else X), spec, iters=_POWER)
            for k in range(d.Ka)])
        W = shrink(xty_f)
        w_star = torch.where(spec.group_ids[None, :] == torch.stack(
            [b for _, b in lm])[:, None], W, 0.0)
    else:
        gspec_f, w_star = None, shrink(xty_f)
    n_bound = masks * (w_star @ X.T)
    return dict(xty_f=xty_f, col_n_f=col_n_f, gspec_f=gspec_f,
                n_bound=n_bound)


def _fold_screen(d: KeyDims, X, Y, masks, spec, st, mus, L: int):
    from ..core.cv import _screen_folds_nn, _screen_folds_sgl
    dt, dev = X.dtype, X.device
    K = d.Ka
    rem = torch.ones((K, L), dtype=dt, device=dev)
    vK = torch.ones(K, dtype=dt, device=dev)
    Beta = torch.zeros((K, d.p), dtype=dt, device=dev)
    theta = Y / 1.0
    if d.sgl:
        return _screen_folds_sgl(
            X, Y, spec, 0.5, rem, vK, vK, theta, st["n_bound"], Beta,
            st["xty_f"], masks, st["col_n_f"], st["gspec_f"], 1e-6, mus,
            screen="tlfre", use_kernels=d.kernels)
    return _screen_folds_nn(X, Y, rem, vK, vK, theta, st["n_bound"], Beta,
                            st["xty_f"], masks, st["col_n_f"], 1e-6,
                            screen="dpc", use_kernels=d.kernels)


def _launch(d: KeyDims, X, masks, dev):
    """The launch's operands (the engine builds them on the card)."""
    from ..core.linalg import spectral_norm
    dt = X.dtype
    Ka = d.Ka
    X_subs = torch.zeros((Ka, d.N, d.p_b), dtype=dt, device=dev)
    idx = torch.empty(d.p_b, dtype=torch.int64, device=dev)
    for t in range(Ka):
        cols = torch.index_select(X, 1, idx)
        if masks is not None:
            cols = cols * masks[t][:, None]
        X_subs[t] = cols
        del cols
    sub_specs = [fake_spec(d.g_b, d.p_b, d.max_size, dev) if d.sgl else None
                 for _ in range(Ka)]
    L_subs = torch.stack([spectral_norm(A, iters=_POWER) ** 2
                          for A in X_subs])
    lams = torch.empty((Ka, d.len2), dtype=dt, device=dev)
    beta0s = torch.zeros((Ka, d.p_b), dtype=dt, device=dev)
    return X_subs, sub_specs, L_subs, lams, beta0s


def price_key(key: tuple, *, device=None, grid_len: Optional[int] = None,
              uniform: Optional[bool] = None) -> dict:
    """Run the key's pieces on fake tensors under one counter; returns
    ``{excess_bytes, graph_bytes, out_bytes, flops, bytes_moved, pieces,
    kernel_calls, collectives}``.  ``grid_len`` is the screen's rows (the
    remaining grid, padded to a power of two; default ``len2``);
    ``uniform`` whether every group has ``max_size`` features (default:
    ``p == G * max_size``)."""
    from ..core.losses import get_loss
    d = key_dims(key)
    dev, card = _route(device)
    loss = get_loss(d.loss)
    L = _pow2_ceil(int(grid_len or d.len2))
    if uniform is None:
        uniform = d.sgl and d.p == d.G * d.max_size
    feat = d.kind.endswith("-feat")
    N, p = d.N, d.p
    with ca.fake_mode():
        if feat:
            p, G = _shard_dims(d)
        else:
            G = d.G
        X = torch.empty((N, p), dtype=d.dtype, device=dev)
        folds = d.kind.endswith("-folds")
        Y = torch.empty((d.Ka, N) if folds else (N,), dtype=d.dtype,
                        device=dev)
        spec = fake_spec(G, p, d.max_size, dev, uniform) if d.sgl else None
        mus = (torch.empty((d.Ka, p), dtype=d.dtype, device=dev)
               if d.centered else None)
        with ca.CostCounter() as c:
            pieces = _Pieces(c)
            if folds:
                masks = torch.empty((d.Ka, N), dtype=d.dtype, device=dev)
                st = _fold_setup(d, X, Y, masks, spec, mus)
                pieces.mark("setup")
                kept = _fold_screen(d, X, Y, masks, spec, st, mus, L)
                del kept
                pieces.mark("screen")
                y = Y[0]
            else:
                masks = None
                y = Y
                st = _setup(d, X, y, spec, loss)
                pieces.mark("setup")
                kept = _screen(d, X, y, spec, st, L, loss)
                del kept
                pieces.mark("screen")
            X_subs, sub_specs, L_subs, lams, beta0s = _launch(d, X, masks,
                                                               dev)
            pieces.mark("launch")
            row, graph = _solve_block(d, X_subs[0], y, sub_specs[0], card,
                                      loss, pieces)
            graph_bytes = 0
            if graph is not None:
                graph_bytes = sum(
                    ca.alloc_bytes(t.untyped_storage().nbytes())
                    for t in _graph_statics(graph))
            cert = _certify_row(d, X, X_subs[0], y, spec, sub_specs[0],
                                row[0], mus[0] if mus is not None else None,
                                loss)
            pieces.mark("certify")
            row_out = sum(ca.alloc_bytes(t.untyped_storage().nbytes())
                          for t in (row[0], cert[0], cert[1]))
    m = pieces.marks
    m["block"] = {k: d.check_every * m["iteration"][k] + m["gap"][k]
                  for k in ("flops", "bytes")}
    m["block"]["peak"] = m["gap"]["peak"]
    rows = d.Ka * d.len2
    blocks = max(int(d.max_iter) // max(int(d.check_every), 1), 1)
    per_row_flops = blocks * m["block"]["flops"] + m["certify"]["flops"]
    per_row_bytes = blocks * m["block"]["bytes"] + m["certify"]["bytes"]
    once = ("setup", "screen", "launch")
    flops = sum(pieces.marks[k]["flops"] for k in once) + rows * per_row_flops
    moved = sum(pieces.marks[k]["bytes"] for k in once) + rows * per_row_bytes
    excess = c.peak - graph_bytes + (rows - 1) * row_out
    return dict(excess_bytes=int(excess), graph_bytes=int(graph_bytes),
                out_bytes=int(rows * row_out), flops=float(flops),
                bytes_moved=float(moved),
                pieces={k: dict(v) for k, v in pieces.marks.items()},
                kernel_calls=dict(c.kernel_calls),
                collectives={k: dict(v) for k, v in c.collectives.items()})


def _graph_statics(graph) -> list:
    """The tensors a captured ``_SGLBlockGraph`` keeps for its life."""
    from ..core.solver import _tensor_fields
    out = [graph.X, graph.y, graph.lam, graph.alpha, graph.t_step, graph.tk,
           graph.gap, graph.t_l1, graph.t_group, graph.beta, graph.z,
           graph.theta]
    out += [getattr(graph.spec, f) for f in _tensor_fields(graph.spec)]
    return out


# ---------------------------------------------------------------------------
# cost cards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostCard:
    """Static resource prediction for one compile key (the reference's
    fields, and the port's graph and workspace terms)."""
    label: str
    key: tuple
    arg_bytes: int               # residents + the launch's operands
    out_bytes: int               # the rows' kept outputs (betas, duals)
    excess_bytes: int            # transient envelope beyond the residents
    peak_bytes: int              # residents + graph + excess + workspace
    resident_bytes: int          # session-persistent operands
    transfer_h2d_bytes: int      # per-launch operands (arg - resident)
    transfer_d2h_bytes: int      # per-launch harvest envelope (= out)
    flops: float                 # loop-expanded envelope
    bytes_moved: float           # loop-expanded operator traffic
    collectives: dict            # kind -> {count, payload_bytes, ...}
    shard: dict                  # mesh/cohort divisibility summary
    graph_bytes: int = 0         # one captured block: statics + workspaces
    workspace_bytes: int = 0     # the library workspaces of one stream
    n_graphs: int = 1            # graphs the card holds (at most)
    pieces: Optional[dict] = None

    @property
    def transfer_bytes(self) -> int:
        return self.transfer_h2d_bytes + self.transfer_d2h_bytes


def card_for_key(key: tuple, label: str = "", *, device=None,
                 mesh_size: int = 1, n_folds: Optional[int] = None,
                 grid_len: Optional[int] = None,
                 uniform: Optional[bool] = None,
                 n_graphs: int = 1) -> CostCard:
    """The :class:`CostCard` of one compile key, priced on fake tensors.
    ``mesh_size`` / ``n_folds`` describe the configured fold mesh for the
    shard-layout summary (collective plans come from
    :func:`collective_plans`); ``n_graphs`` is how many captured blocks of
    the key's size the card holds (a session keeps one a bucket it
    solved)."""
    d = key_dims(key)
    priced = price_key(key, device=device, grid_len=grid_len,
                       uniform=uniform)
    res = _fields_total(resident_fields(key))
    h2d = _fields_total(transfer_fields(key))
    if d.kind.endswith("-feat"):
        from ..distributed.feature_shard import effective_shards
        S_eff = effective_shards(d.G if d.sgl else d.p, d.S)
        shard = {"mesh_size": S_eff, "rows": d.S, "full_cohort": d.S,
                 "sharded": bool(S_eff > 1), "divisible": bool(S_eff == d.S)}
    else:
        Ka = d.Ka
        n_folds = Ka if n_folds is None else n_folds
        shard = {"mesh_size": int(mesh_size), "rows": int(Ka),
                 "full_cohort": int(n_folds),
                 "sharded": bool(mesh_size > 1 and Ka % mesh_size == 0),
                 "divisible": bool(mesh_size <= 1 or n_folds % mesh_size == 0)}
    ws = ca.LIBRARY_WORKSPACE_BYTES
    graph = (priced["graph_bytes"] + ws) if priced["graph_bytes"] else 0
    return CostCard(
        label=label or key[0], key=key, arg_bytes=res + h2d,
        out_bytes=priced["out_bytes"], excess_bytes=priced["excess_bytes"],
        peak_bytes=res + n_graphs * graph + priced["excess_bytes"] + ws,
        resident_bytes=res, transfer_h2d_bytes=h2d,
        transfer_d2h_bytes=priced["out_bytes"], flops=priced["flops"],
        bytes_moved=priced["bytes_moved"],
        collectives=priced["collectives"], shard=shard, graph_bytes=graph,
        workspace_bytes=ws, n_graphs=int(n_graphs) if graph else 0,
        pieces=priced["pieces"])


# ---------------------------------------------------------------------------
# sessions: residents + graphs + the largest transient
# ---------------------------------------------------------------------------

def graph_static_bytes(graph_key: tuple, *, device=None) -> int:
    """Bytes one captured FISTA block keeps for the session's life, for a
    ``fista_sgl_graphed`` cache key ``(N, p_b, g_b, n_max, dtype,
    check_every, loss, device)``: its static buffers and the library
    workspaces its capture took in its private pool."""
    from ..core.losses import get_loss
    from ..core.solver import _SGLBlockGraph
    N, p_b, g_b, n_max, dt, ce, loss = graph_key[:7]
    dev, _ = _route(device)
    with ca.fake_mode():
        X = torch.empty((N, p_b), dtype=_dtype(dt), device=dev)
        y = torch.empty(N, dtype=_dtype(dt), device=dev)
        spec = fake_spec(g_b, p_b, n_max, dev)
        g = _SGLBlockGraph(X, y, spec, torch.ones((), dtype=_dtype(dt),
                                                  device=dev), ce,
                           get_loss(loss))
        return int(sum(ca.alloc_bytes(t.untyped_storage().nbytes())
                       for t in _graph_statics(g))
                   + ca.LIBRARY_WORKSPACE_BYTES)


def session_residents(shape: ProblemShape, n_folds: int = 0,
                      centered: bool = False) -> int:
    """Bytes a session keeps on the card beyond its calls: X, y, the spec
    and the grid anchor ``X^T y``; with a CV, the folds' masks and
    responses (and means, centered)."""
    isz = torch.empty((), dtype=_dtype(shape.dtype)).element_size()
    out = ca.alloc_bytes(shape.N * shape.p * isz) + \
        ca.alloc_bytes(shape.N * isz) + ca.alloc_bytes(shape.p * isz)
    if shape.penalty == "sgl":
        out += sum(ca.alloc_bytes(b) for b in spec_fields(
            shape.G, shape.p, shape.max_size).values())
    if n_folds:
        out += 2 * ca.alloc_bytes(n_folds * shape.N * isz)
        if centered:
            out += ca.alloc_bytes(n_folds * shape.p * isz)
    return int(out)


#: streams a session runs products on: the current one, a capture's
#: warm-up stream and its capture stream
_SESSION_STREAMS = 3


def session_envelope(shape: ProblemShape, keys: Iterable[tuple],
                     graphs: Iterable[tuple], *, device=None,
                     grid_len: Optional[int] = None,
                     n_folds: int = 0, centered: bool = False) -> dict:
    """The predicted peak of a session above what was allocated before it:
    its residents, plus every graph it captured (statics and the library
    workspaces in its pool), plus the largest transient over the keys it
    paid, plus the library workspaces of the ``_SESSION_STREAMS`` streams
    it runs products on (each taken again after a capture clears them).
    Returns the terms and ``total``."""
    uniform = (shape.penalty == "sgl"
               and shape.p == shape.G * shape.max_size)
    # the launch's operands and the rows' outputs are in each transient
    transients = {key: price_key(key, device=device, grid_len=grid_len,
                                 uniform=uniform)["excess_bytes"]
                  for key in keys}
    graph_bytes = {g: graph_static_bytes(g, device=device) for g in graphs}
    res = session_residents(shape, n_folds, centered)
    worst = max(transients.values(), default=0)
    ws = _SESSION_STREAMS * ca.LIBRARY_WORKSPACE_BYTES
    return {"residents": res, "graphs": int(sum(graph_bytes.values())),
            "n_graphs": len(graph_bytes), "transient": int(worst),
            "workspace": ws,
            "total": int(res + sum(graph_bytes.values()) + worst + ws)}


# ---------------------------------------------------------------------------
# collective plans (fake process groups, in a process of their own)
# ---------------------------------------------------------------------------

def _plan_in_world(key: tuple, device, mesh_size: int) -> dict:
    """Inside a fake world: the collectives of one key's pieces run over
    the fake groups (the fold mesh's rank, or a feature block's rank)."""
    from ..launch import mesh as M
    d = key_dims(key)
    dev, _ = _route(device)
    if d.kind.endswith("-folds"):
        M.abstract_fold_mesh(mesh_size)
        return price_key(key, device=device)["collectives"]
    from ..core.dpc import dpc_screen_grid_feat
    from ..core.screening import tlfre_screen_grid_feat
    from ..distributed.feature_shard import (cert_nn, cert_sgl,
                                             feature_ops, sharded_fit)
    group = M.abstract_feature_mesh(mesh_size)
    ops = feature_ops(mesh_size, group, group)
    p_sh, G_sh = _shard_dims(d)
    with ca.fake_mode():
        def e(*shape, dt=d.dtype):
            return torch.empty(shape, dtype=dt, device=dev)
        Xs = e(1, d.N, p_sh)
        specs = [fake_spec(G_sh, p_sh, d.max_size, dev)] if d.sgl else None
        y, lams, col_s, rho = e(d.N), e(d.len2), e(1, p_sh), e(d.N)
        with ca.CostCounter() as c:
            if d.sgl:
                tlfre_screen_grid_feat(ops, Xs, specs, y, 0.5, lams, y, y,
                                       col_s, e(1, G_sh),
                                       use_kernels=d.kernels)
                cert_sgl(ops, Xs, specs, rho, 0.5, d.kernels)
            else:
                dpc_screen_grid_feat(ops, Xs, y, lams, y, y, col_s)
                cert_nn(ops, Xs, rho, d.kernels)
            sharded_fit(ops, Xs, col_s)
    return {k: dict(v) for k, v in c.collectives.items()}


def _plans_child(jobs, device):
    from ..launch.mesh import fake_world
    out = []
    for key, mesh_size in jobs:
        with fake_world(mesh_size):
            out.append(_plan_in_world(key, device, mesh_size))
    return out


def collective_plans(jobs, *, device=None) -> list:
    """The collective plan of each ``(key, mesh_size)``: its pieces traced
    on rank 0 of a fake world of ``mesh_size`` ranks (a fold mesh for
    ``*-folds`` keys, a feature group for ``*-feat`` keys), collectives by
    kind.  Runs in a spawned process: a fake world is the process's
    default group."""
    import multiprocessing as mp
    jobs = [(tuple(_plain(k) for k in key), int(m)) for key, m in jobs]
    with mp.get_context("spawn").Pool(1) as pool:
        return pool.apply(_plans_child, (jobs, device))


def _plain(v):
    """A key component the spawned process can rebuild (the fold mesh of a
    key does not enter its plan)."""
    return v if isinstance(v, (int, float, str, bool, type(None))) else None


def fold_collective_plan(key: tuple, mesh_size: int = 2, *,
                         device=None) -> dict:
    if not key[0].endswith("-folds"):
        raise ValueError("collective plans are defined for fold keys")
    if int(key[1]) % mesh_size != 0:
        raise ValueError(f"cohort {key[1]} does not divide mesh {mesh_size}")
    return collective_plans([(key, mesh_size)], device=device)[0]


def feature_collective_plan(key: tuple, *, device=None) -> dict:
    if not key[0].endswith("-feat"):
        raise ValueError("feature collective plans are defined for *-feat "
                         "keys")
    from ..distributed.feature_shard import effective_shards
    d = key_dims(key)
    S_eff = effective_shards(d.G if d.sgl else d.p, d.S)
    if S_eff <= 1:
        return {}
    return collective_plans([(key, S_eff)], device=device)[0]


# ---------------------------------------------------------------------------
# budgets and findings
# ---------------------------------------------------------------------------

def load_budgets(path: Optional[str]) -> dict:
    budgets = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in DEFAULT_BUDGETS.items()}
    if path:
        with open(path) as f:
            data = json.load(f)
        for k in ("device_hbm_bytes", "allowed_collectives", "configs"):
            if k in data:
                budgets[k] = data[k]
    return budgets


def write_budgets(cards: Iterable[CostCard], path: str, *,
                  hbm_bytes: Optional[int] = None,
                  slack: float = 1.25) -> None:
    """Record the cards as budgets (peak and transfer times ``slack``,
    sorted); feature cards allow all-reduce."""
    configs = {}
    for c in sorted(cards, key=lambda c: c.label):
        entry = {"peak_bytes": int(c.peak_bytes * slack),
                 "transfer_bytes": int(c.transfer_bytes * slack)}
        if c.key[0].endswith("-feat"):
            entry["allowed_collectives"] = ["all-reduce"]
        configs[c.label] = entry
    out = {"device_hbm_bytes": int(hbm_bytes or ca.DEVICE_HBM_BYTES),
           "allowed_collectives": [], "configs": configs}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
        fh.write("\n")


def check_cards(cards: Iterable[CostCard], budgets: dict) -> list:
    """Diff cost cards against the budgets; one finding per violated
    resource rule."""
    findings = []
    hbm = int(budgets.get("device_hbm_bytes",
                          DEFAULT_BUDGETS["device_hbm_bytes"]))
    allowed = set(budgets.get("allowed_collectives", ()))
    configs = budgets.get("configs", {})
    for c in cards:
        if c.peak_bytes > hbm:
            findings.append(Finding(
                "resource/hbm-over-budget", "error", c.label,
                f"static peak {c.peak_bytes / 1e9:.2f} GB exceeds the "
                f"{hbm / 1e9:.1f} GB device budget for key {c.key[0]} "
                f"(residents {c.resident_bytes / 1e9:.2f} GB + graph "
                f"{c.graph_bytes / 1e9:.2f} GB + excess "
                f"{c.excess_bytes / 1e9:.2f} GB)"))
        entry_allowed = configs.get(c.label, {}).get("allowed_collectives")
        allowed_here = (allowed | set(entry_allowed)
                        if entry_allowed is not None else allowed)
        for kind, ent in sorted(c.collectives.items()):
            if kind not in allowed_here:
                findings.append(Finding(
                    "resource/unexpected-collective", "error",
                    f"{c.label}:{kind}",
                    f"sweep body fires {kind} x{ent['count']} moving "
                    f"{ent['payload_bytes'] / 1e6:.2f} MB; only "
                    f"{sorted(allowed_here) or 'no collectives'} are "
                    f"allowed for this card"))
        if not c.shard["divisible"]:
            findings.append(Finding(
                "resource/non-divisible-shard", "error", c.label,
                f"configured fold mesh of {c.shard['mesh_size']} ranks "
                f"does not divide the {c.shard['full_cohort']}-fold "
                f"cohort: every lockstep launch runs unsplit on every rank"))
        entry = configs.get(c.label)
        if entry and c.transfer_bytes > int(entry.get(
                "transfer_bytes", c.transfer_bytes)):
            findings.append(Finding(
                "resource/transfer-in-segment-regression", "error", c.label,
                f"per-launch transfer grew to "
                f"{c.transfer_bytes / 1e6:.2f} MB (h2d "
                f"{c.transfer_h2d_bytes / 1e6:.2f} + d2h "
                f"{c.transfer_d2h_bytes / 1e6:.2f}), above the budgeted "
                f"{int(entry['transfer_bytes']) / 1e6:.2f} MB: a full-p "
                f"operand is being re-shipped per segment"))
    return findings


def verify_shard_layout(mesh_size: int, n_folds: int,
                        label: str = "layout") -> list:
    """The divisibility rule (``distributed.sharding.divisible``) applied
    to a fold cohort."""
    from ..distributed.sharding import divisible
    if mesh_size > 1 and not divisible(n_folds, {"fold": mesh_size},
                                       "fold"):
        return [Finding(
            "resource/non-divisible-shard", "error", label,
            f"fold mesh of {mesh_size} ranks does not divide "
            f"n_folds={n_folds}; shard_over_folds runs every launch "
            f"unsplit and the extra ranks repeat it")]
    return []


# ---------------------------------------------------------------------------
# representative audit (the layer's ``run``)
# ---------------------------------------------------------------------------

def dominating_key(shape: ProblemShape, plan, kind: str,
                   n_folds: Optional[int] = None, device=None) -> tuple:
    """The peak-dominating member of the key universe for one (shape, plan,
    verb): every byte term is monotone in (p_b, g_b, len2, Ka), so the
    largest ladder values price the whole universe.  ``device`` decides
    the ``kernels`` flag (None: the card's route)."""
    from ..core.path_engine import _kernels_active
    N, p, G = shape.N, shape.p, shape.G
    J = _grid_len(plan)
    _, card = _route(device)
    dt = _dtype(shape.dtype)
    kernels = _kernels_active(plan.use_kernels, dt,
                              "cuda" if card else "cpu")
    loss = plan.resolved_loss(shape.loss)
    p_b = max(feature_buckets(p, plan.min_bucket))
    if n_folds is None:
        n_folds = (len(plan.folds) if plan.folds is not None
                   else plan.n_folds)
    if kind == "path":
        len2 = max(chunk_lengths(J, plan.chunk_init, 64))
        shards = int(getattr(plan, "feature_shards", 0))
        from ..distributed.feature_shard import effective_shards
        if shape.penalty == "sgl":
            g_b = max(max(group_buckets(G, plan.min_group_bucket)), G)
            S_eff = effective_shards(G, shards) if shards > 1 else 0
            if S_eff > 1:
                return ("sgl-feat", S_eff, N, p, G, shape.dtype,
                        plan.max_iter, plan.check_every, False, kernels, p_b,
                        g_b, shape.max_size, len2, loss)
            return ("sgl", N, p, G, shape.dtype, plan.max_iter,
                    plan.check_every, kernels, p_b, g_b, shape.max_size,
                    len2, loss)
        S_eff = effective_shards(p, shards) if shards > 1 else 0
        if S_eff > 1:
            return ("nn-feat", S_eff, N, p, shape.dtype, plan.max_iter,
                    plan.check_every, False, kernels, p_b, len2, "squared")
        return ("nn", N, p, shape.dtype, plan.max_iter, plan.check_every,
                kernels, p_b, len2, "squared")
    len2 = max(chunk_lengths(J, plan.chunk_init, plan.chunk_cap))
    if shape.penalty == "sgl":
        g_b = max(group_buckets(G, plan.min_group_bucket))
        return ("sgl-folds", n_folds, N, p, G, shape.dtype, plan.max_iter,
                plan.check_every, plan.mesh, p_b, g_b, shape.max_size, len2,
                plan.center == "per-fold", kernels, loss)
    return ("nn-folds", n_folds, N, p, shape.dtype, plan.max_iter,
            plan.check_every, plan.mesh, p_b, len2, kernels, "squared")


def _shapes():
    return [
        ProblemShape(N=100, p=500, G=50, max_size=10, penalty="sgl",
                     dtype="torch.float64"),
        ProblemShape(N=100, p=500, G=50, max_size=10, penalty="sgl",
                     dtype="torch.float32"),
        ProblemShape(N=80, p=300, G=0, max_size=0, penalty="nn_lasso",
                     dtype="torch.float64"),
    ]


def audit_cards(shapes=None, plan=None, n_folds: int = 4,
                mesh_size: int = 1, device=None) -> list:
    """Cost cards of the representative configurations (the shapes the
    compile audit audits), one per (penalty, dtype, verb), each priced at
    its dominating key."""
    from ..core.problem import Plan
    plan = plan or Plan(n_lambdas=40, n_folds=n_folds)
    cards = []
    for shape in shapes or _shapes():
        for kind in ("path", "cv"):
            key = dominating_key(shape, plan, kind, n_folds=n_folds,
                                 device=device)
            label = f"{shape.penalty}[{shape.dtype.split('.')[-1]}]/{kind}"
            cards.append(card_for_key(key, label, device=device,
                                      mesh_size=mesh_size, n_folds=n_folds,
                                      grid_len=_grid_len(plan)))
    return cards


def feature_audit_cards(shapes=None, plan=None, feature_shards: int = 8,
                        device=None) -> list:
    """Per-rank cost cards of the feature-sharded path sweeps: one block
    of the representative shapes."""
    from ..core.problem import Plan
    plan = (plan or Plan(n_lambdas=40, n_folds=4)).with_(
        feature_shards=feature_shards)
    cards = []
    for shape in shapes or _shapes():
        key = dominating_key(shape, plan, "path", device=device)
        if not key[0].endswith("-feat"):
            continue
        label = (f"{shape.penalty}[{shape.dtype.split('.')[-1]}]"
                 f"/path-feat{feature_shards}")
        cards.append(card_for_key(key, label, device=device,
                                  grid_len=_grid_len(plan)))
    return cards


def run(budgets: Optional[str] = None, device=None) -> list:
    """The layer's entry: price the representative configurations and
    their feature-sharded variants, trace their collective plans on fake
    groups (fold cards on a 2-rank fold mesh, feature cards on their
    shards), and diff against the budgets."""
    from ..core.problem import Plan
    budget_data = load_budgets(budgets)
    plan = Plan(n_lambdas=40, n_folds=4)
    cards = audit_cards(plan=plan, n_folds=4, mesh_size=1, device=device)
    cards.extend(feature_audit_cards(plan=plan, feature_shards=8,
                                     device=device))
    logit = ProblemShape(N=100, p=500, G=50, max_size=10, penalty="sgl",
                         dtype="torch.float64", loss="logistic")
    cards.append(card_for_key(
        dominating_key(logit, plan.with_(screen="gapsafe"), "path",
                       device=device),
        "sgl[logistic]/path", device=device, grid_len=_grid_len(plan)))
    jobs = []
    for c in cards:
        if c.key[0].endswith("-folds"):
            jobs.append((c.key, 2))
        elif c.key[0].endswith("-feat"):
            jobs.append((c.key, c.shard["mesh_size"]))
    plans = iter(collective_plans(jobs, device=device)) if jobs else iter(())
    priced = []
    for c in cards:
        if c.key[0].endswith("-folds"):
            shard = dict(c.shard, mesh_size=2,
                         sharded=c.shard["rows"] % 2 == 0,
                         divisible=c.shard["full_cohort"] % 2 == 0)
            c = dataclasses.replace(c, collectives=next(plans), shard=shard)
        elif c.key[0].endswith("-feat"):
            c = dataclasses.replace(c, collectives=next(plans))
        priced.append(c)
    findings = check_cards(priced, budget_data)
    findings.extend(verify_shard_layout(1, plan.n_folds, "default-plan"))
    return findings


# ---------------------------------------------------------------------------
# capacity planner (--capacity): the largest p a card holds
# ---------------------------------------------------------------------------

def _capacity_key(penalty: str, dtype: str, mode: str, p: int, *, N: int,
                  group_size: int, plan, survivors: Optional[int],
                  feature_shards: int = 0, kernels: bool = False) -> tuple:
    """The dominating key of a scaled-up problem: ``G = p / group_size``
    groups of ``group_size``.  ``survivors`` caps the solve bucket (the
    screening win); ``None`` prices the unscreened worst case (``p_b =
    p``).  ``feature_shards > 1`` (path mode only) prices one shard
    block."""
    J = (len(plan.lambdas) if plan.lambdas is not None
         else int(plan.n_lambdas))
    p_b = p if survivors is None else min(_pow2_ceil(max(int(survivors), 1)),
                                          p)
    cap = 64 if mode == "path" else plan.chunk_cap
    len2 = max(chunk_lengths(J, plan.chunk_init, cap))
    n_folds = (len(plan.folds) if plan.folds is not None
               else plan.n_folds)
    shards = int(feature_shards) if mode == "path" else 0
    dt = f"torch.{dtype}" if "." not in dtype else dtype
    kern = bool(kernels and dt == "torch.float32")
    from ..distributed.feature_shard import effective_shards
    if penalty == "sgl":
        G = max(p // group_size, 1)
        g_b = min(_pow2_ceil(max(p_b // group_size, 1) + 1), G + 1)
        if mode == "path":
            S_eff = effective_shards(G, shards) if shards > 1 else 0
            if S_eff > 1:
                return ("sgl-feat", S_eff, N, p, G, dt, plan.max_iter,
                        plan.check_every, False, kern, p_b, g_b, group_size,
                        len2, "squared")
            return ("sgl", N, p, G, dt, plan.max_iter, plan.check_every,
                    kern, p_b, g_b, group_size, len2, "squared")
        return ("sgl-folds", n_folds, N, p, G, dt, plan.max_iter,
                plan.check_every, None, p_b, g_b, group_size, len2,
                plan.center == "per-fold", kern, "squared")
    if mode == "path":
        S_eff = effective_shards(p, shards) if shards > 1 else 0
        if S_eff > 1:
            return ("nn-feat", S_eff, N, p, dt, plan.max_iter,
                    plan.check_every, False, kern, p_b, len2, "squared")
        return ("nn", N, p, dt, plan.max_iter, plan.check_every, kern, p_b,
                len2, "squared")
    return ("nn-folds", n_folds, N, p, dt, plan.max_iter, plan.check_every,
            None, p_b, len2, kern, "squared")


def _peak_at(p: int, penalty, dtype, mode, *, N, group_size, plan,
             survivors, feature_shards: int = 0, device=None) -> int:
    """The dominating key's card at ``p``, holding as many captured blocks
    as the session can make: one a segment, at most one a lambda of the
    path (a cohort launch a fold and lambda in CV)."""
    _, card = _route(device)
    key = _capacity_key(penalty, dtype, mode, p, N=N, group_size=group_size,
                        plan=plan, survivors=survivors,
                        feature_shards=feature_shards, kernels=card)
    J = _grid_len(plan)
    n_folds = len(plan.folds) if plan.folds is not None else plan.n_folds
    return card_for_key(key, device=device, grid_len=J,
                        n_graphs=J if mode == "path" else n_folds * J
                        ).peak_bytes


def capacity_max_p(penalty: str, dtype: str, mode: str, *, plan,
                   hbm_bytes: int, N: int = 1000, group_size: int = 10,
                   survivors: Optional[int] = 16384,
                   feature_shards: int = 0, device=None) -> int:
    """Largest ``p`` whose dominating key's card fits ``hbm_bytes``.

    For a fixed bucket signature the peak is affine in ``p`` (X, the spec's
    p-long fields, the setup's copies of X and the screen's (L, p) rows
    scale linearly; the bucket pins the rest), so two probes fit the line,
    a confirming probe checks the answer and a short geometric backoff
    corrects ladder effects.  With ``feature_shards > 1`` every probe is
    aligned so the units divide the shard count.  A first probe over the
    budget walks the probe pair down until the lower one fits."""
    shards = int(feature_shards) if mode == "path" else 0
    q = 1
    if shards > 1:
        q = group_size * shards if penalty == "sgl" else shards
    elif penalty == "sgl":
        q = group_size

    def _align(v: int) -> int:
        return max(q * (v // q), q) if q > 1 else v

    kw = dict(N=N, group_size=group_size, plan=plan, survivors=survivors,
              feature_shards=shards, device=device)
    p1, p2 = 1 << 17, 1 << 19
    if survivors is not None:
        p1 = max(p1, _pow2_ceil(int(survivors)) * 2)
        p2 = max(p2, p1 * 4)
    p1, p2 = _align(p1), _align(p2)
    f1 = _peak_at(p1, penalty, dtype, mode, **kw)
    while f1 > hbm_bytes and p1 > (1 << 12):
        p1, p2 = max(_align(p1 // 4), _align(1 << 12)), p1
        f1 = _peak_at(p1, penalty, dtype, mode, **kw)
    if f1 > hbm_bytes:
        return 0
    f2 = _peak_at(p2, penalty, dtype, mode, **kw)
    slope = (f2 - f1) / float(p2 - p1)
    if slope <= 0:
        raise RuntimeError("peak model is not increasing in p")
    base = f1 - slope * p1
    cand = _align(max(int((hbm_bytes - base) / slope), p1))
    for _ in range(20):
        if _peak_at(cand, penalty, dtype, mode, **kw) <= hbm_bytes:
            return cand
        cand = _align(int(cand * 0.96))
    return cand


def capacity_table(plan=None, *, hbm_bytes: Optional[int] = None,
                   N: int = 1000, group_size: int = 10,
                   survivors: int = 16384, feature_shards: int = 8,
                   device=None) -> list:
    """``--capacity`` rows: the largest p on one card for every (penalty,
    dtype, verb), screened (solve bucket capped at ``survivors``) and
    unscreened (``p_b = p``); ``max_p_sharded`` the screened path under
    ``feature_shards`` column blocks (one a rank; None for CV, whose sweeps
    keep the full design)."""
    from ..core.problem import Plan
    plan = plan or Plan()
    hbm = int(hbm_bytes or ca.device_hbm_bytes())
    rows = []
    for penalty in ("sgl", "nn_lasso"):
        for dtype in ("float32", "float64"):
            for mode in ("path", "cv"):
                kw = dict(plan=plan, hbm_bytes=hbm, N=N,
                          group_size=group_size, device=device)
                rows.append({
                    "penalty": penalty, "dtype": dtype, "mode": mode,
                    "max_p_screened": capacity_max_p(
                        penalty, dtype, mode, survivors=survivors, **kw),
                    "max_p_unscreened": capacity_max_p(
                        penalty, dtype, mode, survivors=None, **kw),
                    "max_p_sharded": (capacity_max_p(
                        penalty, dtype, mode, survivors=survivors,
                        feature_shards=feature_shards, **kw)
                        if mode == "path" and feature_shards > 1
                        else None),
                })
    return rows

