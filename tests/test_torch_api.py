"""The port's sklearn-style estimators (``repro_torch.api``) against the live
JAX reference (``repro.api``) on the same numpy data.

Bars (float64): ``coef_`` within 1e-8 (the classifier's within 1e-6),
``lambda_`` equal, ``mse_path_`` within 1e-8.  The reference's estimator
cases of ``tests/test_cv.py``, ``tests/test_session.py`` and
``tests/test_loss_generic.py`` are replayed on the port.  Neither package
defines ``__sklearn_tags__``, so sklearn 1.9's ``GridSearchCV`` refuses both
alike; a two-fold grid run by hand with ``sklearn.base.clone`` stands in
for it.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
import repro_torch.core as T
from repro_torch.examples import sgl_logistic


def regression_data(shift=0.0):
    """``tests/test_cv.py:test_api_sglcv_fit_predict_score``'s data."""
    rng = np.random.default_rng(0)
    N, G, n = 60, 20, 5
    p = G * n
    X = rng.standard_normal((N, p)) + shift
    b = np.zeros(p)
    b[:5] = [1.5, -2.0, 1.0, 0.5, -1.0]
    y = X @ b + 3.0 + 0.05 * rng.standard_normal(N)
    return X, y, [n] * G


def conditioned_data(shift=0.0, nonneg=False):
    """Training rows (60 of 80, four folds) above the features (50): the
    comparisons with the reference.  On ``regression_data`` and
    ``nn_data`` the folds have fewer rows than features, and at the
    grid's small lambdas the two packages' MSE differ by up to 5e-6, as
    the reference's own screened and unscreened runs do (ROADMAP queue
    3)."""
    rng = np.random.default_rng(4)
    N, G, n = 80, 10, 5
    X = rng.standard_normal((N, G * n)) + shift
    b = np.zeros(G * n)
    b[:5] = [1.5, 2.0, 1.0, 0.5, 1.0] if nonneg else \
        [1.5, -2.0, 1.0, 0.5, -1.0]
    y = X @ b + (0.0 if nonneg else 3.0) + 0.3 * rng.standard_normal(N)
    return X, y, [n] * G


def nn_data():
    """``tests/test_cv.py:test_api_nn_lasso_cv``'s data."""
    rng = np.random.default_rng(5)
    N, p = 50, 120
    X = rng.standard_normal((N, p))
    b = np.zeros(p)
    b[:5] = np.abs(rng.standard_normal(5)) + 0.5
    y = X @ b + 0.05 * rng.standard_normal(N)
    return X, y


def logistic_data(seed=8, N=60, G=10, n=4):
    """``tests/test_loss_generic.py:_logistic_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 3, replace=False):
        beta[g * n:g * n + 2] = rng.standard_normal(2)
    y = (X @ beta + 0.5 * rng.standard_normal(N) > 0).astype(float)
    return X, y, [n] * G


def logistic_lam_max(X, y, sizes, alpha):
    spec = T.GroupSpec.from_sizes(sizes, device="cpu")
    xty = torch.as_tensor(X).T @ (torch.as_tensor(y) - 0.5)
    return float(T.lambda_max_sgl(spec, xty, alpha)[0])


CV_KW = dict(alpha=1.0, n_folds=4, n_lambdas=10, tol=1e-10,
             max_iter=50_000)


@pytest.fixture(scope="module")
def sglcv_pair():
    X, y, sizes = conditioned_data()
    est_j = japi.SGLCV(groups=sizes, **CV_KW).fit(X, y)
    est_t = tapi.SGLCV(groups=sizes, device="cpu", **CV_KW).fit(X, y)
    return X, y, sizes, est_j, est_t


def _same_fit(est_t, est_j, atol=1e-8):
    np.testing.assert_allclose(est_t.coef_, np.asarray(est_j.coef_),
                               atol=atol)
    assert np.abs(est_t.coef_).max() > 0.1
    assert est_t.intercept_ == pytest.approx(est_j.intercept_, abs=atol)


def test_sglcv_matches_reference(sglcv_pair):
    X, y, _, est_j, est_t = sglcv_pair
    assert est_t.lambda_ == pytest.approx(est_j.lambda_, rel=1e-12)
    np.testing.assert_allclose(est_t.lambdas_, est_j.lambdas_, rtol=1e-12)
    np.testing.assert_allclose(est_t.mse_path_, est_j.mse_path_, atol=1e-8)
    _same_fit(est_t, est_j)
    assert est_t.lambda_max_ == pytest.approx(est_j.lambda_max_, rel=1e-12)
    assert abs(est_t.n_iter_ - est_j.n_iter_) <= 0.1 * est_j.n_iter_
    assert est_t.score(X, y) == pytest.approx(est_j.score(X, y), abs=1e-10)
    np.testing.assert_allclose(est_t.predict(X), est_j.predict(X),
                               atol=1e-7)


def test_sglregressor_matches_reference(sglcv_pair):
    X, y, sizes, _, est_t = sglcv_pair
    kw = dict(lam=est_t.lambda_, alpha=1.0, groups=sizes, tol=1e-10)
    reg_j = japi.SGLRegressor(**kw).fit(X, y)
    reg_t = tapi.SGLRegressor(device="cpu", **kw).fit(X, y)
    _same_fit(reg_t, reg_j)
    assert reg_t.dual_gap_ <= 1e-10 * 0.5 * float(np.sum(
        (y - y.mean()) ** 2))
    assert reg_t.n_iter_ % 10 == 0 and reg_t.n_iter_ > 0


@pytest.mark.parametrize("selection", ["min", "1se"])
def test_nnlassocv_matches_reference(selection):
    X, y, _ = conditioned_data(nonneg=True)
    # tol 1e-13: at 1e-10 one row stops a check apart in the two packages,
    # and its held-out MSE differs by 4.4e-5
    kw = dict(n_folds=4, n_lambdas=10, tol=1e-13, max_iter=200_000,
              selection=selection)
    est_j = japi.NNLassoCV(**kw).fit(X, y)
    est_t = tapi.NNLassoCV(device="cpu", **kw).fit(X, y)
    assert est_t.lambda_ == pytest.approx(est_j.lambda_, rel=1e-12)
    np.testing.assert_allclose(est_t.mse_path_, est_j.mse_path_, atol=1e-8)
    _same_fit(est_t, est_j)
    assert est_t.coef_.min() >= 0.0


def test_sglclassifier_matches_reference():
    X, y, sizes = logistic_data()
    lam = 0.3 * logistic_lam_max(X, y, sizes, 0.8)
    kw = dict(lam=lam, alpha=0.8, groups=sizes, tol=1e-10,
              max_iter=100_000)
    clf_j = japi.SGLClassifier(**kw).fit(X, y)
    clf_t = tapi.SGLClassifier(device="cpu", **kw).fit(X, y)
    np.testing.assert_allclose(clf_t.coef_, np.asarray(clf_j.coef_),
                               atol=1e-6)
    assert clf_t.lambda_max_ == pytest.approx(clf_j.lambda_max_, rel=1e-12)
    assert clf_t.kept_features_ == clf_j.kept_features_
    np.testing.assert_allclose(clf_t.predict_proba(X),
                               clf_j.predict_proba(X), atol=1e-6)
    assert clf_t.score(X, y) == clf_j.score(X, y)


# ---------------------------------------------------------------------------
# The reference's estimator cases, replayed on the port
# ---------------------------------------------------------------------------

def test_api_sglcv_fit_predict_score():
    """``tests/test_cv.py:274``."""
    X, y, sizes = regression_data()
    est = tapi.SGLCV(groups=sizes, device="cpu", **CV_KW).fit(X, y)
    assert est.score(X, y) > 0.99
    assert abs(est.intercept_ - 3.0) < 0.5
    assert est.mse_path_.shape == (4, 10)
    assert est.lambda_ in est.lambdas_
    ref = tapi.SGLRegressor(lam=est.lambda_, alpha=1.0, groups=sizes,
                            tol=1e-10, device="cpu").fit(X, y)
    np.testing.assert_allclose(ref.coef_, est.coef_, atol=1e-6)
    est1 = tapi.SGLCV(groups=sizes, selection="1se", device="cpu",
                      **CV_KW).fit(X, y)
    assert est1.lambda_ >= est.lambda_


def test_api_nn_lasso_cv():
    """``tests/test_cv.py:299``."""
    X, y = nn_data()
    est = tapi.NNLassoCV(n_folds=4, n_lambdas=10, tol=1e-10,
                         max_iter=50_000, device="cpu").fit(X, y)
    assert est.score(X, y) > 0.98
    assert est.coef_.min() >= 0.0


def test_api_group_spec_validation():
    """``tests/test_cv.py:313``."""
    X = np.zeros((10, 6))
    with pytest.raises(ValueError):
        tapi.SGLRegressor(groups=[4, 4], device="cpu").fit(X, np.zeros(10))


def test_sglcv_estimator_center_per_fold():
    """``tests/test_session.py:293``, and the reference's fit."""
    X, y, sizes = regression_data(shift=0.5)
    kw = dict(alpha=1.0, groups=sizes, n_folds=4, n_lambdas=10,
              center="per-fold", tol=1e-10, max_iter=50_000)
    est = tapi.SGLCV(device="cpu", **kw).fit(X, y)
    assert est.score(X, y) > 0.99
    assert abs(est.intercept_ - 3.0) < 0.5
    ref = est.session_.refine(factor=10, n_lambdas=10)
    assert ref.fine.lambdas.min() <= est.lambda_ <= ref.fine.lambdas.max()


def test_sglcv_center_per_fold_matches_reference():
    X, y, sizes = conditioned_data(shift=0.5)
    kw = dict(alpha=1.0, groups=sizes, n_folds=4, n_lambdas=10,
              center="per-fold", tol=1e-10, max_iter=50_000)
    est_t = tapi.SGLCV(device="cpu", **kw).fit(X, y)
    est_j = japi.SGLCV(**kw).fit(X, y)
    assert est_t.lambda_ == pytest.approx(est_j.lambda_, rel=1e-12)
    np.testing.assert_allclose(est_t.mse_path_, est_j.mse_path_, atol=1e-8)
    _same_fit(est_t, est_j)


def _ref_logistic_fista(X, y, sizes, lam, alpha, iters=20_000):
    """``tests/test_loss_generic.py:_ref_logistic_fista``: plain-numpy
    FISTA on the sparse-group logistic objective, its prox written out from
    the definitions."""
    sizes = np.asarray(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    w = np.sqrt(sizes)
    t = 1.0 / (0.25 * np.linalg.norm(X, 2) ** 2)
    beta = np.zeros(X.shape[1])
    z = beta.copy()
    tk = 1.0
    for _ in range(iters):
        grad = X.T @ (1.0 / (1.0 + np.exp(-(X @ z))) - y)
        v = z - t * grad
        nxt = np.sign(v) * np.maximum(np.abs(v) - t * lam, 0.0)
        for s0, sz, wk in zip(starts, sizes, w):
            seg = nxt[s0:s0 + sz]
            ng = np.linalg.norm(seg)
            thr = t * lam * alpha * wk
            nxt[s0:s0 + sz] = 0.0 if ng <= thr else seg * (1.0 - thr / ng)
        tk_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * tk * tk))
        z = nxt + ((tk - 1.0) / tk_next) * (nxt - beta)
        beta, tk = nxt, tk_next
    return beta


def _logistic_objective(X, y, sizes, lam, alpha, beta):
    u = X @ beta
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    gn = sum(np.sqrt(sz) * np.linalg.norm(beta[s0:s0 + sz])
             for s0, sz in zip(starts, sizes))
    return float(np.sum(np.logaddexp(0.0, u) - y * u)) + lam * (
        alpha * gn + float(np.abs(beta).sum()))


def test_classifier_matches_reference_solver():
    """``tests/test_loss_generic.py:250``."""
    X, y, sizes = logistic_data(8)
    alpha = 0.8
    lam = 0.3 * logistic_lam_max(X, y, sizes, alpha)
    clf = tapi.SGLClassifier(lam=lam, alpha=alpha, groups=sizes, tol=1e-10,
                             max_iter=100_000, device="cpu").fit(X, y)
    ref = _ref_logistic_fista(X, y, sizes, lam, alpha)
    obj_clf = _logistic_objective(X, y, sizes, lam, alpha, clf.coef_)
    obj_ref = _logistic_objective(X, y, sizes, lam, alpha, ref)
    assert obj_clf <= obj_ref + 1e-6
    np.testing.assert_allclose(clf.coef_, ref, atol=1e-3)
    assert clf.score(X, y) > 0.5
    proba = clf.predict_proba(X)
    assert proba.shape == (len(y), 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-12)


ESTIMATORS = {
    "regressor": lambda m: m.SGLRegressor(lam=0.4, alpha=0.6, groups=[2, 3]),
    "classifier": lambda m: m.SGLClassifier(lam=0.4, alpha=0.6,
                                            groups=[2, 3]),
    "sglcv": lambda m: m.SGLCV(alpha=0.6, n_folds=3),
    "nnlassocv": lambda m: m.NNLassoCV(n_folds=3),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_get_set_params_roundtrip(name):
    """``tests/test_loss_generic.py:273``; the port's parameters are the
    reference's plus ``device`` and ``dtype``."""
    est = ESTIMATORS[name](tapi)
    params = est.get_params()
    assert params == type(est)(**params).get_params()
    est.set_params(**params)
    with pytest.raises(ValueError, match="invalid parameter"):
        est.set_params(definitely_not_a_param=1)
    ref = ESTIMATORS[name](japi).get_params()
    assert set(params) == set(ref) | {"device", "dtype"}
    assert all(params[k] == ref[k] for k in ref)
    assert params["device"] is None and params["dtype"] is None
    est.set_params(device="cpu", dtype=torch.float32)
    assert (est.device, est.dtype) == ("cpu", torch.float32)


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimators_survive_sklearn_clone(name):
    """``tests/test_loss_generic.py:283``, for every estimator."""
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    est = ESTIMATORS[name](tapi).set_params(device="cpu",
                                            dtype=torch.float64)
    cl = clone(est)
    assert cl is not est and type(cl) is type(est)
    assert cl.get_params() == est.get_params()


def _grid_by_hand(module, X, y, sizes, lams, **extra):
    """The example's two-fold grid over ``lam``
    (``repro_torch.examples.sgl_logistic.grid_by_hand``) on ``module``'s
    classifier: the best ``lam`` and the mean held-out scores."""
    base = module.SGLClassifier(alpha=1.0, groups=sizes, tol=1e-10,
                                max_iter=20_000, **extra)
    best, _, scores = sgl_logistic.grid_by_hand(base, X, y, lams)
    return best, scores


def test_classifier_grid_by_hand_picks_the_reference_lambda():
    """What ``tests/test_loss_generic.py:291`` asks of ``GridSearchCV``,
    run by hand: both packages pick the same ``lam``, with the same
    held-out accuracies."""
    pytest.importorskip("sklearn")
    X, y, sizes = logistic_data(9)
    lam_max = logistic_lam_max(X, y, sizes, 1.0)
    lams = [0.5 * lam_max, 0.2 * lam_max, 0.05 * lam_max]
    best_t, scores_t = _grid_by_hand(tapi, X, y, sizes, lams, device="cpu")
    best_j, scores_j = _grid_by_hand(japi, X, y, sizes, lams)
    assert best_t == best_j
    np.testing.assert_array_equal(scores_t, scores_j)
    assert all(0.0 <= s <= 1.0 for s in scores_t)


def test_estimators_carry_no_sklearn_tags():
    """Like the reference's, the port's estimators define no
    ``__sklearn_tags__`` (ROADMAP queue 3: sklearn 1.9's ``GridSearchCV``
    refuses both alike)."""
    for name in ESTIMATORS:
        assert not hasattr(ESTIMATORS[name](tapi), "__sklearn_tags__")
        assert not hasattr(ESTIMATORS[name](japi), "__sklearn_tags__")


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_default_device_is_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _ = logistic_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESTIMATORS[name](tapi).fit(X, y)


def test_float32_estimator_keeps_its_dtype_and_agrees_with_float64():
    """``dtype=None`` keeps a float32 input's dtype (the kernel route's
    plain versions here); its fit is within 1e-4 of float64's."""
    X, y, sizes = regression_data()
    kw = dict(lam=2.0, alpha=1.0, groups=sizes, tol=1e-6, device="cpu")
    r32 = tapi.SGLRegressor(**kw).fit(X.astype(np.float32),
                                      y.astype(np.float32))
    r64 = tapi.SGLRegressor(**kw).fit(X, y)
    assert r32.coef_.dtype == np.float32 and r64.coef_.dtype == np.float64
    assert r32.spec_.device.type == "cpu"
    np.testing.assert_allclose(r32.coef_, r64.coef_, atol=1e-4)
    r = tapi.SGLRegressor(dtype=torch.float32, **kw).fit(X, y)
    assert r.coef_.dtype == np.float32
