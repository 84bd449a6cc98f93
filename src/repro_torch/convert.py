"""Carry the reference's data across: numpy arrays in, port objects out, and
a port ``PathResult`` back to numpy; the reference's warm fold state
(``FoldState``) into the port's.

The system runs no model, so the state that has to agree between the two
packages is the problem itself: X, y and the seven children of the
reference's ``GroupSpec`` (``sizes``, ``starts``, ``group_ids``,
``weights``, ``pad_index``, ``pad_mask``, ``feature_weights``), each taken
as a numpy array.
"""
from __future__ import annotations

import numpy as np

from .core.cv import FoldState
from .core.groups import GroupSpec
from .core.path import PathResult
from .core.problem import Problem

SPEC_FIELDS = ("sizes", "starts", "group_ids", "weights", "pad_index",
               "pad_mask", "feature_weights")


def group_spec(children: dict, device=None) -> GroupSpec:
    """GroupSpec from the reference spec's seven children (a mapping of
    field name to numpy array; ``feature_weights`` may be None)."""
    missing = [f for f in SPEC_FIELDS[:6] if f not in children]
    if missing:
        raise ValueError(f"missing GroupSpec fields {missing}")
    return GroupSpec.from_arrays(
        *(children[f] for f in SPEC_FIELDS[:6]),
        children.get("feature_weights"), device=device)


def problem(X, y, children: dict, dtype=None, device=None) -> Problem:
    """An SGL ``Problem`` from numpy X, y and the reference spec's
    children."""
    return Problem.sgl(np.asarray(X), np.asarray(y),
                       group_spec(children, device="cpu"), dtype=dtype,
                       device=device)


def fold_state(state) -> FoldState:
    """The port's ``FoldState`` from the reference's (any object with
    ``lam_bar``, ``theta``, ``c_theta`` and ``beta``), as float64 numpy
    arrays."""
    return FoldState(**{f: np.array(getattr(state, f), dtype=float)
                        for f in ("lam_bar", "theta", "c_theta", "beta")})


def path_result(res: PathResult) -> dict:
    """A port ``PathResult`` as a dict of numpy arrays and floats."""
    out = {
        "lambdas": np.asarray(res.lambdas, dtype=float),
        "betas": np.asarray(res.betas, dtype=float),
        "lam_max": float(res.lam_max),
        "iters": np.asarray(res.iters),
        "kept_features": np.asarray(res.kept_features),
    }
    if res.kept_groups is not None:
        out["kept_groups"] = np.asarray(res.kept_groups)
    if res.stats is not None:
        s = res.stats
        out.update(n_segments=s.n_segments, n_screens=s.n_screens,
                   n_compilations=s.n_compilations, n_rejected=s.n_rejected,
                   n_pallas_screens=s.n_pallas_screens)
    return out
