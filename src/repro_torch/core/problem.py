"""Declarative problem / plan specification (PyTorch port).

  * ``Problem`` — WHAT is being solved: the design matrix, the response,
    the group structure (SGL), the penalty family (``sgl`` or
    ``nn_lasso``) and the loss (``squared`` or ``logistic``), as tensors on
    one device.
  * ``Plan`` — HOW to solve it: lambda grid, alpha, screening rule and
    engine knobs.  It keeps the reference's fields; ``use_pallas`` becomes
    ``use_kernels``.  A value this port does not implement yet raises
    ``NotImplementedError`` naming the ROADMAP item that brings it; no field
    is silently ignored.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .groups import GroupSpec, resolve_device

PENALTIES = ("sgl", "nn_lasso")
LOSSES = ("squared", "logistic")

# screening rules per penalty family; "auto" resolves to the first entry.
# TLFre's dual geometry is squared-loss-only, so a non-squared loss
# restricts to the Gap-Safe family.
_SCREENS = {"sgl": ("tlfre", "gapsafe", "none"),
            "nn_lasso": ("dpc", "gapsafe", "none")}
_SCREENS_NON_SQUARED = ("gapsafe", "none")

_WARNED: set = set()


def warn_legacy_entry_point(name: str, replacement: str) -> None:
    """One ``DeprecationWarning`` per legacy entry point per process: the
    shims (``sgl_path(engine='batched')``, ``sgl_cv``, ...) call the same
    engine with the same arguments, so a warning per call would be noise."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{name} is a legacy entry point kept as a thin shim; prefer "
        f"{replacement} (see the Problem/Plan/Session migration guide in "
        f"README.md)", DeprecationWarning, stacklevel=3)


def as_group_spec(groups, p: int, device) -> GroupSpec:
    """Accept a GroupSpec, a list of group sizes, or None (singletons)."""
    if isinstance(groups, GroupSpec):
        if groups.num_features != p:
            raise ValueError(f"GroupSpec covers {groups.num_features} "
                             f"features, X has {p}")
        return groups.to(device)
    if groups is None:
        return GroupSpec.from_sizes([1] * p, device=device)
    spec = GroupSpec.from_sizes(groups, device=device)
    if spec.num_features != p:
        raise ValueError(f"group sizes sum to {spec.num_features}, X has {p}")
    return spec


def input_dtype(a, dtype=None) -> torch.dtype:
    """The compute dtype for input ``a``: ``dtype`` if given, else ``a``'s
    floating dtype (float32 for a non-floating input)."""
    if dtype is not None:
        return dtype
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.zeros(0, np.asarray(a).dtype))
    return a.dtype if a.is_floating_point() else torch.float32


def _as_tensor(a, dtype, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=input_dtype(t, dtype)).contiguous()


@dataclasses.dataclass(frozen=True)
class Problem:
    """Immutable problem spec: (X, y, groups, penalty family), all on one
    device.  ``dtype`` pins the compute precision — float64 for exactness
    runs, float32 for the CUDA kernels."""
    X: torch.Tensor              # (N, p) design
    y: torch.Tensor              # (N,) response
    spec: Optional[GroupSpec]    # group structure (None only for nn_lasso)
    penalty: str = "sgl"
    loss: str = "squared"

    def __post_init__(self):
        if self.penalty not in PENALTIES:
            raise ValueError(f"unknown penalty {self.penalty!r}; "
                             f"expected one of {PENALTIES}")
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; "
                             f"expected one of {LOSSES}")
        if self.penalty == "sgl" and self.spec is None:
            raise ValueError("penalty='sgl' requires a GroupSpec")
        if self.penalty == "nn_lasso" and self.loss != "squared":
            raise ValueError("nn_lasso supports only the squared loss "
                             "(the DPC dual geometry is squared-only)")
        if self.X.dim() != 2 or self.y.dim() != 1:
            raise ValueError("X must be (N, p) and y (N,)")
        if self.X.shape[0] != self.y.shape[0]:
            raise ValueError(f"X has {self.X.shape[0]} rows, "
                             f"y has {self.y.shape[0]}")
        if self.loss == "logistic" and not bool(
                torch.all((self.y == 0.0) | (self.y == 1.0))):
            raise ValueError("loss='logistic' requires labels in {0, 1}")

    @classmethod
    def sgl(cls, X, y, groups=None, dtype=None, device=None) -> "Problem":
        """``device=None`` means the CUDA card (and raises without one);
        pass ``device='cpu'`` to run on the CPU.  ``dtype=None`` keeps X's
        floating dtype."""
        device = resolve_device(device)
        X = _as_tensor(X, dtype, device)
        y = _as_tensor(y, X.dtype, device)
        return cls(X=X, y=y, spec=as_group_spec(groups, X.shape[1], device))

    @classmethod
    def sgl_logistic(cls, X, y, groups=None, dtype=None,
                     device=None) -> "Problem":
        """Sparse-group logistic regression: the SGL penalty on the
        binomial negative log-likelihood.  ``y`` must be 0/1 labels.
        ``device`` and ``dtype`` as in ``Problem.sgl``."""
        device = resolve_device(device)
        X = _as_tensor(X, dtype, device)
        y = _as_tensor(y, X.dtype, device)
        return cls(X=X, y=y, spec=as_group_spec(groups, X.shape[1], device),
                   loss="logistic")

    @classmethod
    def nn_lasso(cls, X, y, dtype=None, device=None) -> "Problem":
        """The nonnegative Lasso (paper Section 5).  ``device`` and
        ``dtype`` as in ``Problem.sgl``: ``device=None`` means the card."""
        device = resolve_device(device)
        X = _as_tensor(X, dtype, device)
        y = _as_tensor(y, X.dtype, device)
        return cls(X=X, y=y, spec=None, penalty="nn_lasso")

    @property
    def n_samples(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device


@dataclasses.dataclass(frozen=True)
class Plan:
    """Declarative run configuration (the reference's fields)."""
    # ---- penalty / grid ---------------------------------------------------
    alpha: float = 1.0
    lambdas: Optional[np.ndarray] = None
    n_lambdas: int = 100
    min_ratio: float = 0.01
    # ---- loss / adaptive weights ------------------------------------------
    loss: str = "auto"
    group_weights: object = None
    feature_weights: object = None
    # ---- screening / solver ----------------------------------------------
    screen: str = "auto"
    engine: str = "batched"
    tol: float = 1e-9
    max_iter: int = 20000
    safety: float = 0.0
    specnorm_method: str = "power"
    check_every: int = 10
    # ---- batched-engine knobs --------------------------------------------
    use_kernels: Optional[bool] = None  # fused f32 kernels (None: f32 on
    #                              CUDA; True on a float64 problem raises)
    min_bucket: int = 64
    min_group_bucket: int = 16
    margin: float = 0.125
    chunk_init: int = 8
    # ---- elastic fold scheduling (cv / refine / stability / serving) ------
    schedule: str = "elastic"
    chunk_cap: int = 64
    # ---- model selection (cv / refine) -----------------------------------
    n_folds: int = 5
    folds: Optional[list] = None
    seed: int = 0
    center: str = "global"
    selection: str = "min"
    # ---- stability selection ---------------------------------------------
    n_subsamples: int = 50
    subsample_frac: float = 0.5
    active_tol: float = 1e-8
    batch_size: int = 10
    # ---- execution --------------------------------------------------------
    mesh: object = None
    feature_shards: int = 0      # > 1: group-aligned column sharding of X
    #                              (distributed.feature_shard) for the
    #                              screens and certificates: across a
    #                              torch.distributed group of that many
    #                              ranks, else stacked on one device

    def with_(self, **overrides) -> "Plan":
        """A copy with the given fields replaced (a Plan is immutable)."""
        return dataclasses.replace(self, **overrides)

    def resolved_loss(self, problem_loss: str = "squared") -> str:
        """The effective loss: the plan's explicit choice, or the
        problem's (``loss='auto'``, the default)."""
        loss = problem_loss if self.loss == "auto" else self.loss
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}; "
                             f"expected one of {('auto',) + LOSSES}")
        return loss

    def resolved_screen(self, penalty: str = "sgl",
                        loss: str = "squared") -> str:
        allowed = _SCREENS[penalty]
        if loss != "squared":
            allowed = _SCREENS_NON_SQUARED
        screen = allowed[0] if self.screen == "auto" else self.screen
        if screen not in allowed:
            raise ValueError(f"screen={screen!r} is not valid for "
                             f"penalty={penalty!r} with loss={loss!r}; "
                             f"expected one of {('auto',) + allowed}")
        return screen

    def validate_for_penalty(self, penalty: str,
                             loss: str = "squared") -> None:
        """Penalty-level validation (no Problem instance needed)."""
        self.resolved_screen(penalty, loss)
        if loss != "squared":
            if self.engine != "batched":
                raise ValueError(f"loss={loss!r} requires engine='batched' "
                                 "(the legacy per-lambda engine is "
                                 "squared-only)")
            if int(self.feature_shards) > 1:
                raise ValueError(f"loss={loss!r} does not support "
                                 "feature_shards (the sharded screens are "
                                 "squared-only)")
        if self.feature_weights is not None and int(self.feature_shards) > 1:
            raise ValueError("adaptive feature_weights do not support "
                             "feature_shards; drop one or the other")
        if self.engine not in ("batched", "legacy"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.schedule not in ("elastic", "lockstep"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.chunk_cap < 2:
            raise ValueError("chunk_cap must be >= 2")
        if self.center not in ("global", "per-fold"):
            raise ValueError(f"unknown center mode {self.center!r}")
        if self.selection not in ("min", "1se"):
            raise ValueError(f"unknown selection rule {self.selection!r}")
        if int(self.feature_shards) < 0:
            raise ValueError("feature_shards must be >= 0")
        if int(self.feature_shards) > 1 and self.engine != "batched":
            raise ValueError("feature_shards > 1 requires engine='batched' "
                             "(the legacy driver is single-device)")
        if penalty == "nn_lasso" and self.center == "per-fold":
            raise ValueError("per-fold centering is not defined for the "
                             "nonnegative Lasso (centering X breaks the "
                             "nonnegativity geometry)")

    def validate(self, problem: Problem) -> None:
        """The reference's validation."""
        loss = self.resolved_loss(problem.loss)
        if problem.penalty == "nn_lasso" and loss != "squared":
            raise ValueError("nn_lasso supports only the squared loss")
        self.validate_for_penalty(problem.penalty, loss)
        if problem.penalty == "nn_lasso" and (
                self.group_weights is not None
                or self.feature_weights is not None):
            raise ValueError("adaptive weights are SGL-only (the nn_lasso "
                             "penalty has no group/feature weights)")
        if self.use_kernels and problem.dtype == torch.float64:
            from .screening import _require_f32_for_pallas
            _require_f32_for_pallas(problem.dtype)

    def grid(self, lam_max: float) -> np.ndarray:
        """The lambda grid this plan runs: explicit, or the paper protocol
        anchored at ``lam_max``."""
        from .path import default_lambda_grid
        if self.lambdas is not None:
            return np.asarray(self.lambdas, dtype=float)
        return default_lambda_grid(lam_max, self.n_lambdas, self.min_ratio)
