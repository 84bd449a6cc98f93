"""Carry the reference's data across: numpy arrays in, port objects out, and
back.

* The path engine: X, y and the seven children of the reference's
  ``GroupSpec`` (``sizes``, ``starts``, ``group_ids``, ``weights``,
  ``pad_index``, ``pad_mask``, ``feature_weights``), each a numpy array; a
  port ``PathResult`` back to numpy; the reference's warm fold state
  (``FoldState``) into the port's.
* The LM: the reference's parameter tree (nested dicts of numpy leaves)
  into a ``ParamTree`` and back (``lm_params``, ``lm_params_numpy``), and a
  reference ``TrainState`` into the port's and back (``lm_train_state``,
  ``lm_train_state_numpy``).  Leaf names and shapes are the same on both
  sides; with ``shardings`` (``distributed.sharding.named``) each leaf is
  this rank's block.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cv import FoldState
from .core.groups import GroupSpec, resolve_device
from .core.path import PathResult
from .core.problem import Problem
from .pytree import ParamTree, as_dict, tree_map

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


def _tensor(a, device):
    return torch.as_tensor(np.array(a), device=device)


def _blocks(tree, shardings, device):
    """Each leaf of ``tree`` (arrays) as a tensor on ``device``: this
    rank's block by the matching leaf of ``shardings``, or whole."""
    if shardings is None:
        return tree_map(lambda a: _tensor(a, device), tree)
    return tree_map(lambda a, s: _tensor(s.local(np.asarray(a)), device),
                    tree, shardings)


def lm_params(tree, device=None, shardings=None) -> ParamTree:
    """A ``ParamTree`` from the reference's parameter tree (nested dicts of
    arrays; each leaf is copied) on ``device`` (``None``: the card; raises
    without CUDA); with ``shardings`` (a matching tree of
    ``NamedSharding``) each leaf is this rank's block."""
    device = resolve_device(device)
    return ParamTree(_blocks(tree, shardings, device))


def lm_params_numpy(params) -> dict:
    """The port's parameters as the reference's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(),
                    as_dict(params))


def lm_train_state(state, device=None, shardings=None):
    """The port's ``TrainState`` from the reference's (any object with
    ``step``, ``params``, ``m`` and ``v``) on ``device`` (``None``: the card;
    raises without CUDA); with ``shardings`` (a ``TrainState`` of
    ``NamedSharding`` trees, ``named(mesh, state_pspecs(...))``) each leaf
    is this rank's block."""
    from .optim.adamw import TrainState
    device = resolve_device(device)
    sh = shardings or TrainState(None, None, None, None)
    return TrainState(_tensor(state.step, device).to(torch.int32),
                      lm_params(state.params, device, sh.params),
                      _blocks(state.m, sh.m, device),
                      _blocks(state.v, sh.v, device))


def lm_train_state_numpy(state) -> dict:
    """The port's ``TrainState`` as a dict of the reference's fields
    (``step``, ``params``, ``m``, ``v``) over numpy arrays."""
    host = lambda t: tree_map(lambda a: a.detach().cpu().numpy().copy(),
                              as_dict(t))
    return {"step": state.step.detach().cpu().numpy().copy(),
            "params": host(state.params), "m": host(state.m),
            "v": host(state.v)}
