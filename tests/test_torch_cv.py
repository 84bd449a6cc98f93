"""The port's fold-batched cross-validation, ``SGLSession.cv``, against the
live JAX reference on the same numpy problems.

Tolerances:

* float64 at ``tol=1e-13`` (the bar of ``tests/test_torch_path.py``):
  per-fold betas, ``mse_path`` and ``mean_mse`` within 1e-8; the folds,
  ``best_index`` and ``index_1se`` equal.  Under ``schedule='lockstep'``
  the engine's structure agrees exactly: segments, screens, compilations,
  rejections, buckets, per-fold sweep launches and kept sets.  Total FISTA
  iterations agree within 10%: the Lipschitz estimates differ in their last
  digits (the port seeds the power method from numpy), and at this
  tolerance the gap test reads values at float64 rounding.
* Under the default elastic schedule only betas and the selection are
  held: the reference harvests whichever launch its device finished first,
  so its launch order is not fixed.
* float32 through the kernel route (the plain versions on the CPU) against
  the reference's ``use_pallas=True`` interpret route: betas within 1e-5,
  and every stacked screen through the fold-stack kernels.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import cv as jcv
from repro_torch import convert
from repro_torch.core import cv as tcv

F64 = dict(n_folds=3, n_lambdas=10, tol=1e-13, max_iter=200_000,
           min_bucket=32)
F32 = dict(n_folds=3, n_lambdas=8, min_ratio=0.05, tol=1e-6, safety=1e-4,
           max_iter=20000, min_bucket=32)


def sgl_problem(seed=7, N=60, G=30, n=5):
    """``tests/test_cv.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 4, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


def nn_problem(seed=3, N=50, p=160):
    """``tests/test_cv.py:_nn_problem``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 10, replace=False)] = np.abs(rng.standard_normal(10))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


def wide_rows_problem(seed=120, N=60, G=4, n=5):
    """Training rows (40) > p (20), so that both float32 solutions sit
    within rounding of the optimum, as on ``tests/test_torch_kernels.py``'s
    float32 path shapes."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    beta[:2] = np.abs(rng.standard_normal(2))
    beta[n:n + 2] = np.abs(rng.standard_normal(2))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


def _sessions(penalty, dtype=np.float64):
    """(JAX session, port session) on one problem: the float64 problems of
    ``tests/test_cv.py``, or for float32 one with N > p."""
    X, y, sizes = sgl_problem() if dtype == np.float64 else \
        wide_rows_problem()
    if penalty == "nn_lasso" and dtype == np.float64:
        X, y = nn_problem()
    X, y = X.astype(dtype), y.astype(dtype)
    if penalty == "sgl":
        jspec = J.GroupSpec.from_sizes(sizes)
        return (J.SGLSession(J.Problem.sgl(X, y, jspec)),
                T.SGLSession(convert.problem(X, y, _children(jspec),
                                             device="cpu")))
    return (J.SGLSession(J.Problem.nn_lasso(X, y)),
            T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")))


LOCKSTEP = {"sgl-global": ("sgl", {}),
            "sgl-per-fold": ("sgl", dict(center="per-fold")),
            "nn": ("nn_lasso", {})}


@pytest.fixture(scope="module")
def lockstep_runs():
    """Each lockstep case once: (reference result, port result, port
    session), shared by the tests below."""
    runs = {}
    for case, (penalty, extra) in LOCKSTEP.items():
        sj, st = _sessions(penalty)
        kw = dict(F64, schedule="lockstep", **extra)
        runs[case] = (sj.cv(J.Plan(**kw)), st.cv(T.Plan(**kw)), st, kw)
    return runs


def _assert_same_cv(rt, rj, atol=1e-8):
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.fold_betas, rj.fold_betas, atol=atol)
    assert np.abs(rt.fold_betas).max() > 0.1
    np.testing.assert_allclose(rt.mse_path, rj.mse_path, atol=atol)
    np.testing.assert_allclose(rt.mean_mse, rj.mean_mse, atol=atol)
    assert rt.best_index == rj.best_index
    assert rt.index_1se == rj.index_1se
    assert len(rt.folds) == len(rj.folds)
    for (tr_t, va_t), (tr_j, va_j) in zip(rt.folds, rj.folds):
        np.testing.assert_array_equal(tr_t, tr_j)
        np.testing.assert_array_equal(va_t, va_j)


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_cv_f64_lockstep_matches_live_reference(lockstep_runs, case):
    rj, rt, _, _ = lockstep_runs[case]
    _assert_same_cv(rt, rj)
    sj, st = rj.stats, rt.stats
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "n_pallas_screens", "buckets"):
        assert getattr(st, f) == getattr(sj, f), f
    np.testing.assert_array_equal(st.fold_sweeps, sj.fold_sweeps)
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert st.n_pallas_screens == 0          # float64 never engages them
    assert abs(int(rt.fold_iters.sum()) - int(rj.fold_iters.sum())) <= \
        0.1 * int(rj.fold_iters.sum())


@pytest.mark.parametrize("case", sorted(LOCKSTEP))
def test_cv_warm_second_call_pays_no_compilation(lockstep_runs, case):
    _, rt, sess, kw = lockstep_runs[case]
    warm = sess.cv(T.Plan(**kw))
    assert warm.stats.n_compilations == 0
    np.testing.assert_array_equal(warm.fold_betas, rt.fold_betas)


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_cv_f64_elastic_matches_live_reference(penalty):
    sj, st = _sessions(penalty)
    rj = sj.cv(J.Plan(**F64))
    rt = st.cv(T.Plan(**F64))
    _assert_same_cv(rt, rj)
    assert rt.stats.fold_sweeps.shape == (F64["n_folds"],)


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_cv_f32_kernel_route_matches_reference_pallas_route(penalty):
    from repro_torch.kernels import ops
    sj, st = _sessions(penalty, np.float32)
    rj = sj.cv(J.Plan(**F32, use_pallas=True))
    ops.reset_launch_counts()
    rt = st.cv(T.Plan(**F32, use_kernels=True))
    np.testing.assert_allclose(rt.fold_betas, rj.fold_betas, atol=1e-5)
    assert rt.stats.n_pallas_screens == rt.stats.n_screens > 0
    assert rj.stats.n_pallas_screens == rj.stats.n_screens
    assert sum(ops.launch_counts().values()) == 0    # plain versions here


@pytest.mark.parametrize("N,K,seed", [(10, 3, 0), (50, 5, 0), (17, 4, 3),
                                      (250, 5, 0)])
def test_kfold_indices_equal_the_reference(N, K, seed):
    for (tr_t, va_t), (tr_j, va_j) in zip(tcv.kfold_indices(N, K, seed),
                                          jcv.kfold_indices(N, K, seed)):
        np.testing.assert_array_equal(tr_t, tr_j)
        np.testing.assert_array_equal(va_t, va_j)
    with pytest.raises(ValueError):
        tcv.kfold_indices(3, 4)


def test_per_fold_centering_and_statistics_match_reference():
    X, y, _ = sgl_problem()
    folds = tcv.kfold_indices(len(y), 3, seed=1)
    masks = tcv._masks_from_folds(folds, len(y))
    np.testing.assert_array_equal(masks, jcv._masks_from_folds(folds,
                                                                len(y)))
    for a, b in zip(tcv.per_fold_centering(X, y, masks),
                    jcv.per_fold_centering(X, y, masks)):
        np.testing.assert_allclose(a, b, rtol=1e-14)
    rng = np.random.default_rng(0)
    betas = rng.standard_normal((3, 6, X.shape[1])) * 0.1
    lambdas = np.geomspace(1.0, 0.1, 6)
    kept = np.zeros((3, 6), dtype=np.int64)
    mus, y_means, _ = jcv.per_fold_centering(X, y, masks)
    for m, ym in ((None, None), (mus, y_means)):
        rt = tcv._cv_statistics(X, y, folds, lambdas, betas, 1.0, kept,
                                None, (0.0, 0.0, 0.0), mus=m, y_means=ym)
        rj = jcv._cv_statistics(X, y, folds, lambdas, betas, 1.0, kept,
                                None, (0.0, 0.0, 0.0), mus=m, y_means=ym)
        np.testing.assert_allclose(rt.mse_path, rj.mse_path, rtol=1e-14)
        assert (rt.best_index, rt.index_1se) == (rj.best_index, rj.index_1se)


@pytest.mark.parametrize("args", [
    ((8, [(3, 3), (4, 4)], None, 64), 16),
    ((8, [(3, 3), (2, 4)], None, 64), 2),
    ((8, [(4, 4), (1, 2)], [False, True], 64), 16),
    ((32, [(32, 32)], None, 64), 64),
])
def test_chunk_policies_match_reference(args):
    spec_m, accepted, limited, cap = args[0]
    assert tcv._next_chunk_len(spec_m, accepted, limited, cap) == \
        jcv._next_chunk_len(spec_m, accepted, limited, cap) == args[1]
    for chunk, kk, mk in ((8, 8, 8), (8, 3, 8), (40, 40, 40), (2, 1, 2)):
        assert tcv._next_fold_chunk(chunk, kk, mk, 64) == \
            jcv._next_fold_chunk(chunk, kk, mk, 64)
    lambdas = np.geomspace(1.0, 0.01, 11)
    j_pos = np.asarray([2, 5, 11, 0])
    act = np.asarray([0, 1, 3])
    np.testing.assert_array_equal(tcv._build_rem(lambdas, j_pos, act),
                                  jcv._build_rem(lambdas, j_pos, act))


def test_cv_float64_with_kernels_requested_raises():
    _, st = _sessions("sgl")
    with pytest.raises(TypeError):
        st.cv(T.Plan(n_lambdas=4, n_folds=3, use_kernels=True))


@pytest.mark.parametrize("call,item", [
    (lambda s: s.cv(T.Plan(n_lambdas=4, n_folds=3, loss="logistic")),
     "masked-row embedding"),
])
def test_cv_unported_features_raise_not_implemented(call, item):
    _, st = _sessions("sgl")
    with pytest.raises(NotImplementedError, match=item):
        call(st)


def test_cv_gapsafe_runs_and_matches_live_reference():
    """``screen='gapsafe'`` in CV, once refused, runs: float64, betas and
    MSE within 1e-8 of the reference (``tests/test_torch_gapsafe.py`` holds
    the counters and both penalties)."""
    sj, st = _sessions("sgl")
    kw = dict(F64, screen="gapsafe")
    rj, rt = sj.cv(J.Plan(**kw)), st.cv(T.Plan(**kw))
    np.testing.assert_allclose(rt.fold_betas, rj.fold_betas, atol=1e-8)
    np.testing.assert_allclose(rt.mse_path, rj.mse_path, atol=1e-8)
    assert rt.stats.n_screens == rj.stats.n_screens > 0


def test_cv_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, sizes = sgl_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SGLSession(T.Problem.sgl(X, y, sizes)).cv(T.Plan(n_lambdas=4))
