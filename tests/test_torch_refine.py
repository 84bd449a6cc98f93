"""The port's warm two-stage grid refinement, ``SGLSession.refine``, with
``init=`` / ``FoldState``, against the live JAX reference on the same numpy
problems.

Tolerances (float64, tol <= 1e-10): fold betas and ``mse_path`` within
1e-8; the selected index and lambda, the warm-start lambda and the new
compilations equal; total FISTA iterations within 10% (the port seeds the
power method from numpy, so the Lipschitz estimates differ in their last
digits, as ``tests/test_torch_path.py`` explains).  The schedule is
lockstep where counters are compared: under the elastic schedule the
reference harvests whichever launch its device finished first.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core import cv as jcv
from repro_torch import convert
from repro_torch.core import cv as tcv

# tests/test_session.py:187's plan: the buckets pinned (min_bucket >= p,
# min_group_bucket > G) so the fine window's sweep shapes are the coarse
# run's
PINNED = dict(n_lambdas=16, tol=1e-10, max_iter=200_000, min_bucket=256,
              min_group_bucket=32, n_folds=4)


def sgl_problem(seed=7, N=60, G=30, n=5, k_active=4, noise=0.01):
    """``tests/test_session.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, k_active, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + noise * rng.standard_normal(N)
    return X, y, [n] * G


def nn_problem(seed=5, N=80, p=56):
    """``tests/test_session.py:test_nn_shims_match_bitwise``'s data, with
    more training rows than features: off the screen the nonnegative
    Lasso's own conditioning on N < p moves betas by about 1e-7 (ROADMAP
    queue 3)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p))
    b = np.zeros(p)
    b[:6] = np.abs(rng.standard_normal(6)) + 0.5
    y = X @ b + 0.3 * rng.standard_normal(N)
    return X, y


def _sessions(penalty, shift=0.0):
    """(reference session, port session) on one float64 problem."""
    if penalty == "nn_lasso":
        X, y = nn_problem()
        return (J.SGLSession(J.Problem.nn_lasso(X, y)),
                T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")))
    X, y, sizes = sgl_problem(seed=11, N=80, G=24, n=5, noise=0.5)
    X, y = X + shift, y + 2.0 * shift
    return (J.SGLSession(J.Problem.sgl(X, y, J.GroupSpec.from_sizes(sizes))),
            T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")))


# tol 1e-12, and 1e-14 for per-fold centering: at 1e-10 to 1e-13 one
# per-fold-centered row stops, in one package, a check earlier than in the
# other, and their betas there differ by 1.6e-7, both certified
CASES = {"sgl-global": ("sgl", 0.0, dict(tol=1e-12)),
         "sgl-per-fold": ("sgl", 0.7, dict(center="per-fold", tol=1e-14)),
         "nn": ("nn_lasso", 0.0, dict(tol=1e-12))}


STATE_POINTS = (0, 3, 8)


@pytest.fixture(scope="module")
def refine_runs():
    """Each case's lockstep ``cv`` then ``refine(factor=10)`` on both
    packages: (reference cv, refine, fold states; port cv, refine, fold
    states).  The fold states are taken before ``refine``
    (which replaces the warm state), the port's from the reference's
    stored solutions, so that ``_fold_state_at`` alone is compared."""
    runs = {}
    for case, (penalty, shift, extra) in CASES.items():
        sj, st = _sessions(penalty, shift)
        kw = dict(PINNED, schedule="lockstep", **extra)
        cj, ct = sj.cv(J.Plan(**kw)), st.cv(T.Plan(**kw))
        own = st._last_cv
        st._last_cv = dataclasses.replace(own, result=dataclasses.replace(
            ct, fold_betas=np.array(cj.fold_betas)))
        states = [(sj._fold_state_at(j), st._fold_state_at(j),
                   float(cj.lambdas[j])) for j in STATE_POINTS]
        st._last_cv = own
        rj, rt = sj.refine(factor=10.0), st.refine(factor=10.0)
        runs[case] = (cj, rj, ct, rt, states)
    return runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_matches_live_reference(refine_runs, case):
    cj, rj, ct, rt, _ = refine_runs[case]
    np.testing.assert_allclose(ct.fold_betas, cj.fold_betas, atol=1e-8)
    np.testing.assert_allclose(rt.fine.lambdas, rj.fine.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.fine.fold_betas, rj.fine.fold_betas,
                               atol=1e-8)
    assert np.abs(rt.fine.fold_betas).max() > 0.1
    np.testing.assert_allclose(rt.fine.mse_path, rj.fine.mse_path,
                               atol=1e-8)
    assert (rt.index, rt.fine.best_index, rt.fine.index_1se) == \
        (rj.index, rj.fine.best_index, rj.fine.index_1se)
    assert rt.lambda_ == pytest.approx(rj.lambda_, rel=1e-12)
    assert rt.warm_start_lambda == pytest.approx(rj.warm_start_lambda,
                                                 rel=1e-12)
    assert np.isfinite(rt.warm_start_lambda)
    assert rt.new_compilations == rj.new_compilations
    assert abs(rt.total_iters - rj.total_iters) <= 0.1 * rj.total_iters
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "buckets"):
        assert getattr(rt.fine.stats, f) == getattr(rj.fine.stats, f), f
    assert rt.coarse is ct


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_state_at_matches_reference(refine_runs, case):
    """``_fold_state_at`` on the same stored solutions: lam_bar, theta,
    c_theta and beta within 1e-8.  Grid point 0 is the full-data
    lambda_max, above every fold's own here: the at-max clamp fires for
    every fold there, and for none at the later points."""
    for j, (fj, ft, lam_ref) in zip(STATE_POINTS, refine_runs[case][4]):
        for f in ("lam_bar", "theta", "c_theta", "beta"):
            np.testing.assert_allclose(getattr(ft, f),
                                       np.asarray(getattr(fj, f)),
                                       atol=1e-8, rtol=1e-10, err_msg=f)
        clamped = ft.lam_bar < lam_ref * (1.0 - 1e-12)
        assert clamped.all() == (j == 0) and clamped.any() == (j == 0)
        np.testing.assert_array_equal(ft.beta[clamped], 0.0)
        if j:
            assert np.abs(ft.beta).max() > 0.1


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_reference_fold_state_seeds_the_port_engine(penalty):
    """The reference's ``FoldState`` at a coarse grid point, carried over by
    ``convert.fold_state``, seeds the port's fold driver on a finer grid:
    the reference's betas within 1e-8."""
    sj, st = _sessions(penalty)
    kw = dict(PINNED, n_lambdas=10)
    coarse = sj.cv(J.Plan(**kw))
    fs = sj._fold_state_at(4)
    fine = np.geomspace(coarse.lambdas[4] * 0.999, coarse.lambdas[6], 7)
    masks = jcv._masks_from_folds(coarse.folds, sj.problem.n_samples)
    y = np.asarray(sj.problem.y)
    opts = dict(tol=1e-10, max_iter=200_000, min_bucket=256)
    init_t = convert.fold_state(fs)
    assert isinstance(init_t, tcv.FoldState)
    if penalty == "sgl":
        opts["min_group_bucket"] = 32
        bj = jcv.sgl_fold_paths(sj.problem.X, y, sj.problem.spec, 1.0,
                                masks, fine, init=fs, **opts)[0]
        bt = tcv.sgl_fold_paths(st.problem.X, y, st.problem.spec, 1.0,
                                masks, fine, init=init_t, **opts)[0]
    else:
        bj = jcv.nn_fold_paths(sj.problem.X, y, masks, fine, init=fs,
                               **opts)[0]
        bt = tcv.nn_fold_paths(st.problem.X, y, masks, fine, init=init_t,
                               **opts)[0]
    np.testing.assert_allclose(bt, bj, atol=1e-8)
    assert np.abs(bt).max() > 0.1


def test_init_changes_the_warm_start_not_the_answer():
    """A fold state seeds the chain, and the certified betas stay the cold
    run's (to the solve tolerance)."""
    _, st = _sessions("sgl")
    coarse = st.cv(T.Plan(**PINNED))
    fs = st._fold_state_at(5)
    fine = np.geomspace(coarse.lambdas[5] * 0.999, coarse.lambdas[8], 6)
    X, y, spec = st.problem.X, st.problem.y, st.problem.spec
    masks = tcv._masks_from_folds(coarse.folds, st.problem.n_samples)
    opts = dict(tol=1e-10, max_iter=200_000, min_bucket=256,
                min_group_bucket=32)
    warm = tcv.sgl_fold_paths(X, y, spec, 1.0, masks, fine, init=fs, **opts)
    cold = tcv.sgl_fold_paths(X, y, spec, 1.0, masks, fine, **opts)
    np.testing.assert_allclose(warm[0], cold[0], atol=1e-8)
    assert warm[2].sum() < cold[2].sum()       # fewer FISTA iterations


# ---------------------------------------------------------------------------
# tests/test_session.py's refine cases, replayed on the port
# ---------------------------------------------------------------------------

def test_refine_matches_exhaustive_fine_cv_warm():
    """``tests/test_session.py:187``: session.refine equals an exhaustive
    fine-grid CV to grid resolution, with no new solver compilation and
    fewer total FISTA iterations."""
    X, y, sizes = sgl_problem(seed=11, N=80, G=24, n=5, noise=0.5)
    plan = T.Plan(**PINNED)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    coarse = sess.cv(plan)
    ref = sess.refine(factor=10.0, n_lambdas=16)

    cold = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")).cv(
        plan.with_(lambdas=ref.fine.lambdas))
    np.testing.assert_allclose(ref.fine.fold_betas, cold.fold_betas,
                               atol=1e-8)
    assert abs(ref.index - cold.best_index) <= 1
    step = abs(np.log(ref.fine.lambdas[1] / ref.fine.lambdas[0]))
    assert abs(np.log(ref.lambda_ / cold.best_lambda)) <= step + 1e-12

    assert ref.new_compilations == 0
    assert ref.total_iters < int(cold.fold_iters.sum())
    assert ref.fine.lambdas.min() <= coarse.best_lambda
    assert coarse.best_lambda <= ref.fine.lambdas.max()
    assert ref.warm_start_lambda >= ref.fine.lambdas.max() * (1 - 1e-12)


def test_refine_composes_and_requires_cv():
    """``tests/test_session.py:222``, with every field the reference
    refuses to change."""
    X, y, sizes = sgl_problem(seed=2, N=50, G=16, n=4)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    with pytest.raises(RuntimeError):
        sess.refine(factor=10)
    plan = T.Plan(n_lambdas=10, tol=1e-9, max_iter=100_000, min_bucket=128,
                  min_group_bucket=32, n_folds=3)
    sess.cv(plan)
    r1 = sess.refine(factor=25.0, n_lambdas=10)
    r2 = sess.refine(factor=5.0, n_lambdas=10)   # refines the refinement
    assert r2.coarse is r1.fine

    def width(r):
        return np.log(r.fine.lambdas.max() / r.fine.lambdas.min())
    assert width(r2) <= width(r1) + 1e-9
    assert r2.fine.lambdas.min() <= r1.lambda_ <= r2.fine.lambdas.max()
    with pytest.raises(ValueError):
        sess.refine(factor=1.0)
    for bad in (dict(alpha=0.5), dict(n_folds=4), dict(seed=1),
                dict(center="per-fold"), dict(loss="squared"),
                dict(folds=tcv.kfold_indices(50, 3, 0)),
                dict(group_weights=np.ones(16)),
                dict(feature_weights=np.ones(64))):
        with pytest.raises(ValueError, match="refine cannot change"):
            sess.refine(factor=5.0, **bad)


def test_refine_window_at_lambda_max_seeds_from_the_top():
    """A window that reaches the full-data lambda_max is seeded at the
    grid's first point, where every fold takes its clamped all-zero
    state; the betas are the reference's."""
    X, y, sizes = sgl_problem(seed=2, N=50, G=16, n=4)
    kw = dict(n_lambdas=8, tol=1e-12, max_iter=100_000, min_bucket=128,
              min_group_bucket=32, n_folds=3)
    sj = J.SGLSession(J.Problem.sgl(X, y, J.GroupSpec.from_sizes(sizes)))
    st = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    ct = st.cv(T.Plan(**kw))
    sj.cv(J.Plan(**kw))
    around = 0.9 * ct.lam_max
    rj = sj.refine(around=around, factor=4.0, n_lambdas=6)
    rt = st.refine(around=around, factor=4.0, n_lambdas=6)
    assert rt.warm_start_lambda == ct.lambdas[0]
    assert rt.warm_start_lambda == pytest.approx(rj.warm_start_lambda,
                                                 rel=1e-12)
    assert rt.fine.lambdas[0] == pytest.approx(ct.lam_max * (1 - 1e-9))
    np.testing.assert_allclose(rt.fine.fold_betas, rj.fine.fold_betas,
                               atol=1e-8)
    assert rt.index == rj.index


def test_cv_refine_stability_shims_exported():
    for name in ("FoldState", "StabilityResult", "stability_selection",
                 "subsample_masks", "RefineResult"):
        assert hasattr(T, name), name
