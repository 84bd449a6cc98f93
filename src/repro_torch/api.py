"""sklearn-style estimators over the Problem/Plan/Session API (PyTorch port).

Fit/predict/score estimators whose ``fit`` runs K-fold model selection over
a lambda grid and refits at the selected regularization.  No sklearn
dependency: the classes follow its estimator protocol (the constructor
stores its arguments untouched; ``fit`` sets trailing-underscore
attributes), so they drop into code that relies on duck typing.

  SGLRegressor   one (lambda, alpha) Sparse-Group Lasso fit
  SGLClassifier  one (lambda, alpha) sparse-group LOGISTIC regression fit
                 (Gap-Safe screening from the logistic dual)
  SGLCV          fold-batched K-fold CV over the grid, then a refit
  NNLassoCV      the nonnegative-Lasso analogue (DPC screening)

Every estimator implements ``get_params`` / ``set_params`` (derived from the
constructor signature), so it survives ``sklearn.base.clone``.  Like the
reference's, the estimators define no ``__sklearn_tags__`` and inherit no
sklearn base class.

Two keyword parameters are the port's own: ``device`` (``None`` means the
CUDA card and raises without one; ``'cpu'`` runs on the CPU) and ``dtype``
(``None`` keeps the input's floating dtype, as ``Problem.sgl`` does).  At
float32 the refits take the kernel route (``solve_sgl(use_kernels=True)``:
graphed ``sgl_prox`` blocks on the card, in ``SGLCV`` from the session's
graph cache); at float64 the plain loop.

Each CV estimator builds a ``core.Problem`` and ``core.Plan`` and runs them
through a ``core.SGLSession``, exposed after ``fit`` as ``session_``, so
``est.session_.refine(...)`` continues warm from the CV state.  Grids are
anchored at the full-data lambda_max.

Centering: with ``fit_intercept`` the data is centered once on the full
sample before CV (``center='global'``: cheap and standard, but the held-out
rows leak into the fold means).  ``center='per-fold'`` scores leakage-free
models instead: each fold is centered by its own train-row means, through
rank-one corrections of the masked-row embedding (the final refit's
intercept still comes from the full sample).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .core import (Plan, Problem, SGLSession, solve_nn_lasso, solve_sgl,
                   spectral_norm)
from .core.cv import _host
from .core.problem import input_dtype


def _center(X, y, fit_intercept: bool):
    X = _host(X)
    y = _host(y)
    if not fit_intercept:
        return X, y, np.zeros(X.shape[1]), 0.0
    x_mean = X.mean(axis=0)
    y_mean = float(y.mean())
    return X - x_mean, y - y_mean, x_mean, y_mean


def _lipschitz(X: torch.Tensor) -> float:
    return float(spectral_norm(X)) ** 2


class _ParamsMixin:
    """sklearn estimator introspection without the sklearn dependency.

    ``get_params`` enumerates the constructor signature (sklearn's
    convention: every ``__init__`` argument is stored verbatim on an
    attribute of the same name), which is what ``sklearn.base.clone``
    calls; ``set_params(**kw)`` checks names against the same signature so
    a typo fails loudly instead of fitting defaults."""

    @classmethod
    def _param_names(cls):
        sig = inspect.signature(cls.__init__)
        return [n for n, prm in sig.parameters.items()
                if n != "self" and prm.kind not in (prm.VAR_POSITIONAL,
                                                    prm.VAR_KEYWORD)]

    def get_params(self, deep: bool = True):
        return {n: getattr(self, n) for n in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for name, value in params.items():
            if name not in valid:
                raise ValueError(
                    f"invalid parameter {name!r} for estimator "
                    f"{type(self).__name__}; valid parameters: "
                    f"{sorted(valid)}")
            setattr(self, name, value)
        return self


class _LinearBase(_ParamsMixin):
    """Shared predict/score for fitted linear models."""

    coef_: np.ndarray
    intercept_: float

    def predict(self, X):
        return _host(X) @ self.coef_ + self.intercept_

    def score(self, X, y):
        """Coefficient of determination R^2."""
        y = _host(y)
        resid = y - self.predict(X)
        denom = float(np.sum((y - y.mean()) ** 2))
        if denom == 0.0:
            return 0.0
        return 1.0 - float(np.sum(resid * resid)) / denom


class SGLRegressor(_LinearBase):
    """Sparse-Group Lasso at one (lam, alpha), FISTA with duality-gap stop.

    ``lam`` is the paper's lambda (l1 scale); ``alpha`` the group/l1 mix,
    so the group penalty is ``alpha * lam * sum_g w_g ||beta_g||``.
    ``groups`` is a GroupSpec, a list of group sizes, or None for singleton
    groups.
    """

    def __init__(self, lam: float = 1.0, alpha: float = 1.0, groups=None,
                 fit_intercept: bool = True, tol: float = 1e-9,
                 max_iter: int = 20000, device=None, dtype=None):
        self.lam = lam
        self.alpha = alpha
        self.groups = groups
        self.fit_intercept = fit_intercept
        self.tol = tol
        self.max_iter = max_iter
        self.device = device
        self.dtype = dtype

    def fit(self, X, y):
        Xc, yc, x_mean, y_mean = _center(X, y, self.fit_intercept)
        prob = Problem.sgl(Xc, yc, self.groups,
                           dtype=input_dtype(X, self.dtype),
                           device=self.device)
        res = solve_sgl(prob.X, prob.y, prob.spec, float(self.lam),
                        float(self.alpha), _lipschitz(prob.X),
                        max_iter=self.max_iter, tol=self.tol,
                        use_kernels=prob.dtype == torch.float32)
        self.spec_ = prob.spec
        self.coef_ = res.beta.cpu().numpy()
        self.intercept_ = y_mean - float(x_mean @ self.coef_)
        self.n_iter_ = int(res.iters)
        self.dual_gap_ = float(res.gap)
        return self


class SGLClassifier(_ParamsMixin):
    """Sparse-group logistic regression at one (lam, alpha).

    The SGL penalty on the binomial negative log-likelihood, solved by the
    batched engine with Gap-Safe screening from the logistic dual
    (``screen='gapsafe'``; TLFre's geometry is squared-loss-only).  ``y``
    must be 0/1 labels.  No intercept is fitted: append a constant column
    if an unpenalized intercept is needed.

    After ``fit``: ``coef_``, ``n_iter_``, ``kept_features_`` (columns
    surviving the screen), ``lambda_max_`` and ``session_`` (the live
    session).  ``predict_proba`` returns ``(n, 2)`` class probabilities;
    ``score`` is the classification accuracy.
    """

    def __init__(self, lam: float = 1.0, alpha: float = 1.0, groups=None,
                 screen: str = "gapsafe", tol: float = 1e-8,
                 max_iter: int = 20000, device=None, dtype=None):
        self.lam = lam
        self.alpha = alpha
        self.groups = groups
        self.screen = screen
        self.tol = tol
        self.max_iter = max_iter
        self.device = device
        self.dtype = dtype

    def fit(self, X, y):
        prob = Problem.sgl_logistic(_host(X), _host(y), self.groups,
                                    dtype=input_dtype(X, self.dtype),
                                    device=self.device)
        plan = Plan(alpha=float(self.alpha),
                    lambdas=np.asarray([float(self.lam)]),
                    screen=self.screen, tol=self.tol,
                    max_iter=self.max_iter)
        session = SGLSession(prob, plan)
        res = session.path()
        self.spec_ = prob.spec
        self.session_ = session
        self.coef_ = np.asarray(res.betas[0])
        self.intercept_ = 0.0
        self.n_iter_ = int(res.iters[0])
        self.kept_features_ = int(res.kept_features[0])
        self.lambda_max_ = float(res.lam_max)
        return self

    def decision_function(self, X):
        return _host(X) @ self.coef_ + self.intercept_

    def predict_proba(self, X):
        """(n, 2) class probabilities [P(y=0), P(y=1)]."""
        p1 = 1.0 / (1.0 + np.exp(-self.decision_function(X)))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, X):
        return (self.decision_function(X) > 0.0).astype(float)

    def score(self, X, y):
        """Classification accuracy."""
        return float(np.mean(self.predict(X) == _host(y)))


class SGLCV(_LinearBase):
    """Fold-batched K-fold cross-validated Sparse-Group Lasso.

    ``fit`` runs ``SGLSession.cv``, selects lambda by mean held-out MSE
    (``selection='min'``) or the 1-SE rule (``selection='1se'``), and
    refits on the full sample at the selected lambda.  ``center='per-fold'``
    scores leakage-free per-fold-centered models (see the module
    docstring).  Exposes ``lambdas_``, ``mse_path_``, ``lambda_``,
    ``cv_result_`` and the live ``session_`` (e.g.
    ``est.session_.refine(factor=10)``).
    """

    def __init__(self, alpha: float = 1.0, groups=None, n_folds: int = 5,
                 n_lambdas: int = 100, min_ratio: float = 0.01,
                 lambdas=None, screen: str = "tlfre",
                 selection: str = "min", fit_intercept: bool = True,
                 center: str = "global", tol: float = 1e-9,
                 max_iter: int = 20000, safety: float = 0.0, seed: int = 0,
                 mesh=None, device=None, dtype=None):
        self.alpha = alpha
        self.groups = groups
        self.n_folds = n_folds
        self.n_lambdas = n_lambdas
        self.min_ratio = min_ratio
        self.lambdas = lambdas
        self.screen = screen
        self.selection = selection
        self.fit_intercept = fit_intercept
        self.center = center
        self.tol = tol
        self.max_iter = max_iter
        self.safety = safety
        self.seed = seed
        self.mesh = mesh
        self.device = device
        self.dtype = dtype

    def fit(self, X, y):
        Xc, yc, x_mean, y_mean = _center(X, y, self.fit_intercept)
        prob = Problem.sgl(Xc, yc, self.groups,
                           dtype=input_dtype(X, self.dtype),
                           device=self.device)
        plan = Plan(alpha=float(self.alpha), lambdas=self.lambdas,
                    n_lambdas=self.n_lambdas, min_ratio=self.min_ratio,
                    screen=self.screen, tol=self.tol,
                    max_iter=self.max_iter, safety=self.safety,
                    n_folds=self.n_folds, seed=self.seed,
                    center=self.center, selection=self.selection,
                    mesh=self.mesh)
        session = SGLSession(prob, plan)
        cv = session.cv()
        idx = cv.best_index if self.selection == "min" else cv.index_1se
        lam = float(cv.lambdas[idx])
        res = solve_sgl(prob.X, prob.y, prob.spec, lam, float(self.alpha),
                        _lipschitz(prob.X), max_iter=self.max_iter,
                        tol=self.tol,
                        use_kernels=prob.dtype == torch.float32,
                        graphs=session.fista_graphs)
        self.spec_ = prob.spec
        self.session_ = session
        self.cv_result_ = cv
        self.lambdas_ = cv.lambdas
        self.mse_path_ = cv.mse_path
        self.lambda_ = lam
        self.lambda_max_ = cv.lam_max
        self.coef_ = res.beta.cpu().numpy()
        self.intercept_ = y_mean - float(x_mean @ self.coef_)
        self.n_iter_ = int(res.iters)
        return self


class NNLassoCV(_LinearBase):
    """Fold-batched K-fold cross-validated nonnegative Lasso (DPC)."""

    def __init__(self, n_folds: int = 5, n_lambdas: int = 100,
                 min_ratio: float = 0.01, lambdas=None, screen: str = "dpc",
                 selection: str = "min", tol: float = 1e-9,
                 max_iter: int = 20000, safety: float = 0.0, seed: int = 0,
                 mesh=None, device=None, dtype=None):
        self.n_folds = n_folds
        self.n_lambdas = n_lambdas
        self.min_ratio = min_ratio
        self.lambdas = lambdas
        self.screen = screen
        self.selection = selection
        self.tol = tol
        self.max_iter = max_iter
        self.safety = safety
        self.seed = seed
        self.mesh = mesh
        self.device = device
        self.dtype = dtype
        # no fit_intercept: centering X breaks the nonnegativity geometry

    def fit(self, X, y):
        prob = Problem.nn_lasso(_host(X), _host(y),
                                dtype=input_dtype(X, self.dtype),
                                device=self.device)
        plan = Plan(lambdas=self.lambdas, n_lambdas=self.n_lambdas,
                    min_ratio=self.min_ratio, screen=self.screen,
                    tol=self.tol, max_iter=self.max_iter,
                    safety=self.safety, n_folds=self.n_folds,
                    seed=self.seed, selection=self.selection,
                    mesh=self.mesh)
        session = SGLSession(prob, plan)
        cv = session.cv()
        idx = cv.best_index if self.selection == "min" else cv.index_1se
        lam = float(cv.lambdas[idx])
        res = solve_nn_lasso(prob.X, prob.y, lam, _lipschitz(prob.X),
                             max_iter=self.max_iter, tol=self.tol)
        self.session_ = session
        self.cv_result_ = cv
        self.lambdas_ = cv.lambdas
        self.mse_path_ = cv.mse_path
        self.lambda_ = lam
        self.lambda_max_ = cv.lam_max
        self.coef_ = res.beta.cpu().numpy()
        self.intercept_ = 0.0
        self.n_iter_ = int(res.iters)
        return self
