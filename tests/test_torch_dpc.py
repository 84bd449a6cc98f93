"""The port's DPC nonnegative-Lasso pieces and path against the live JAX
reference on the same numpy problems.

Tolerances:

* The building blocks (``lambda_max_nn``, ``dual_scaling_nn``, the DPC grid
  screens, ``fista_nn_lasso``) in float64: 1e-12 relative on values, equal
  keep masks.
* The fold-stacked screens (``tlfre_screen_grid_folds`` with and without
  the centering correction, ``dpc_screen_grid_folds``) in float64: equal
  keep masks, radii 1e-12 relative.
* The path, ``SGLSession(Problem.nn_lasso(...)).path(Plan())``, in float64
  at ``tol=1e-13``: betas 1e-8, and the same segments, screens,
  compilations, rejections, buckets and kept sets.  Total FISTA iterations
  agree within 10%, for the reason ``tests/test_torch_path.py`` gives.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import dpc as jdpc
from repro.core import screening as jscr
from repro.core.solver import fista_nn_lasso as j_fista_nn


def nn_problem(seed=3, N=50, p=160):
    """``tests/test_cv.py:_nn_problem``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 10, replace=False)] = np.abs(rng.standard_normal(10))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def test_lambda_max_and_dual_scaling_nn_match_reference():
    X, y = nn_problem()
    xty = X.T @ y
    lm_t, i_t = T.lambda_max_nn(_t(xty))
    lm_j, i_j = jdpc.lambda_max_nn(jnp.asarray(xty))
    assert float(lm_t) == pytest.approx(float(lm_j), rel=1e-14)
    assert int(i_t) == int(i_j)
    for scale in (0.3, 1.0, 4.0):
        c = xty / float(lm_j) * scale
        assert float(T.dual_scaling_nn(_t(c))) == pytest.approx(
            float(jdpc.dual_scaling_nn(jnp.asarray(c))), rel=1e-14)


@pytest.mark.parametrize("at_max", [True, False])
def test_dpc_screen_grid_matches_reference(at_max):
    X, y = nn_problem()
    xty = X.T @ y
    lam_max, i_star = float(np.max(xty)), int(np.argmax(xty))
    lam_bar = lam_max if at_max else 0.6 * lam_max
    rng = np.random.default_rng(1)
    theta = y / lam_bar if at_max else (y - X @ np.abs(
        rng.standard_normal(X.shape[1])) * 0.01) / lam_bar
    lambdas = lam_bar * np.asarray([0.95, 0.8, 0.5, 0.3])
    col_n = np.sqrt((X * X).sum(axis=0))
    n_t = T.normal_vector_nn(_t(X), _t(y), lam_bar, lam_max, _t(theta),
                             i_star)
    n_j = jdpc.normal_vector_nn(jnp.asarray(X), jnp.asarray(y), lam_bar,
                                lam_max, jnp.asarray(theta), i_star)
    np.testing.assert_allclose(_np(n_t), np.asarray(n_j), rtol=1e-12)
    fk_t, r_t = T.dpc_screen_grid(_t(X), _t(y), _t(lambdas), _t(theta), n_t,
                                  _t(col_n), safety=1e-9)
    fk_j, r_j = jdpc.dpc_screen_grid(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(lambdas), jnp.asarray(theta),
                                     n_j, jnp.asarray(col_n), safety=1e-9)
    np.testing.assert_array_equal(_np(fk_t), np.asarray(fk_j))
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=1e-12)
    assert 0 < int(_np(fk_t).sum()) < fk_t.numel()


def test_nn_objectives_match_reference():
    X, y = nn_problem()
    beta = np.abs(np.random.default_rng(2).standard_normal(X.shape[1])) * .1
    theta = (y - X @ beta) / 3.0
    assert float(T.nn_primal_objective(_t(X), _t(y), _t(beta), 3.0)) == \
        pytest.approx(float(jdpc.nn_primal_objective(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta), 3.0)),
            rel=1e-13)
    assert float(T.nn_dual_objective(_t(y), _t(theta), 3.0)) == \
        pytest.approx(float(jdpc.nn_dual_objective(
            jnp.asarray(y), jnp.asarray(theta), 3.0)), rel=1e-13)


@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_fista_nn_lasso_matches_reference(frac):
    X, y = nn_problem()
    lam = frac * float(np.max(X.T @ y))
    L = float(np.linalg.norm(X, 2) ** 2)
    beta0 = np.zeros(X.shape[1])
    rt = T.fista_nn_lasso(_t(X), _t(y), lam, L, _t(beta0), max_iter=20000,
                          check_every=10, tol=1e-12)
    rj = j_fista_nn(jnp.asarray(X), jnp.asarray(y), lam, L,
                    jnp.asarray(beta0), max_iter=20000, check_every=10,
                    tol=1e-12)
    np.testing.assert_allclose(_np(rt.beta), np.asarray(rj.beta), atol=1e-8)
    assert rt.iters == int(rj.iters)
    assert float(rt.gap) <= 1e-12 * 0.5 * float(y @ y)
    assert (_np(rt.beta) >= 0).all()


def _fold_inputs(seed=0, K=3, N=40, G=12, n=4, L=5):
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    y = X[:, :3] @ np.asarray([1.0, -0.5, 0.7]) + 0.01 * rng.standard_normal(N)
    masks = np.zeros((K, N))
    for k, (train, _) in enumerate(J.kfold_indices(N, K, seed=0)):
        masks[k, train] = 1.0
    Y = masks * y[None, :]
    lam_max = np.max(np.abs(Y @ X), axis=1)
    lambdas = lam_max[:, None] * np.linspace(0.9, 0.3, L)[None, :]
    lam_bar = lam_max * 0.95
    Theta = (Y / lam_max[:, None] * 0.9
             + 0.01 * masks * rng.standard_normal((K, N)))
    N_vecs = Y / lam_bar[:, None] - Theta
    N_vecs[0] = 0.0                        # the zero-normal guard
    col_n = np.sqrt(masks @ (X * X))
    mus = (masks @ X) / masks.sum(axis=1)[:, None]
    gspec = np.sqrt(np.stack([
        np.bincount(np.repeat(np.arange(G), n), weights=c2, minlength=G)
        for c2 in masks @ (X * X)]))
    return X, Y, lambdas, Theta, N_vecs, col_n, gspec, mus, [n] * G


@pytest.mark.parametrize("centered", [False, True])
def test_tlfre_screen_grid_folds_matches_reference(centered):
    X, Y, lambdas, Theta, N_vecs, col_n, gspec, mus, sizes = _fold_inputs()
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    gk_j, fk_j, r_j = jscr.tlfre_screen_grid_folds(
        jnp.asarray(X), jnp.asarray(Y), jspec, 0.8, jnp.asarray(lambdas),
        jnp.asarray(Theta), jnp.asarray(N_vecs), jnp.asarray(col_n),
        jnp.asarray(gspec), safety=1e-9,
        mus=jnp.asarray(mus) if centered else None)
    gk_t, fk_t, r_t = T.tlfre_screen_grid_folds(
        _t(X), _t(Y), tspec, 0.8, _t(lambdas), _t(Theta), _t(N_vecs),
        _t(col_n), _t(gspec), safety=1e-9,
        mus=_t(mus) if centered else None)
    np.testing.assert_array_equal(_np(gk_t), np.asarray(gk_j))
    np.testing.assert_array_equal(_np(fk_t), np.asarray(fk_j))
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=1e-12)
    assert 0 < int(_np(fk_t).sum()) < fk_t.numel()


def test_dpc_screen_grid_folds_matches_reference():
    X, Y, lambdas, Theta, N_vecs, col_n, _, _, _ = _fold_inputs(seed=1)
    fk_j, r_j = jdpc.dpc_screen_grid_folds(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lambdas),
        jnp.asarray(Theta), jnp.asarray(N_vecs), jnp.asarray(col_n),
        safety=1e-9)
    fk_t, r_t = T.dpc_screen_grid_folds(
        _t(X), _t(Y), _t(lambdas), _t(Theta), _t(N_vecs), _t(col_n),
        safety=1e-9)
    np.testing.assert_array_equal(_np(fk_t), np.asarray(fk_j))
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=1e-12)
    assert 0 < int(_np(fk_t).sum()) < fk_t.numel()


def test_fold_screens_refuse_float64_on_the_kernel_route():
    X, Y, lambdas, Theta, N_vecs, col_n, gspec, _, sizes = _fold_inputs()
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    with pytest.raises(TypeError):
        T.dpc_screen_grid_folds(_t(X), _t(Y), _t(lambdas), _t(Theta),
                                _t(N_vecs), _t(col_n), use_kernels=True)
    with pytest.raises(TypeError):
        T.tlfre_screen_grid_folds(_t(X), _t(Y), tspec, 1.0, _t(lambdas),
                                  _t(Theta), _t(N_vecs), _t(col_n),
                                  _t(gspec), use_kernels=True)


NN_CASES = {"dpc": dict(n_lambdas=12, min_bucket=32),
            "none": dict(n_lambdas=12, min_bucket=32, screen="none")}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nn_path_f64_matches_live_reference(case):
    kw = dict(NN_CASES[case], tol=1e-13, max_iter=200_000)
    X, y = nn_problem()
    rj = J.SGLSession(J.Problem.nn_lasso(X, y)).path(J.Plan(**kw))
    sess = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu"))
    rt = sess.path(T.Plan(**kw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.1 and (rt.betas >= 0).all()
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "buckets"):
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert abs(int(rt.iters.sum()) - int(rj.iters.sum())) <= \
        0.1 * int(rj.iters.sum())
    warm = sess.path(T.Plan(**kw))
    assert warm.stats.n_compilations == 0
    np.testing.assert_array_equal(warm.betas, rt.betas)


def test_nn_path_f32_kernel_route_matches_reference_pallas_route():
    """The float32 path through the kernel route (``xtv`` certification,
    its plain version on the CPU) against the reference's
    ``use_pallas=True`` interpret route."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((60, 40))
    beta = np.zeros(40)
    beta[:4] = np.abs(rng.standard_normal(4))
    y = X @ beta + 0.01 * rng.standard_normal(60)
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(n_lambdas=10, min_ratio=0.05, tol=1e-6, safety=1e-4,
              max_iter=20000, min_bucket=32)
    rj = J.SGLSession(J.Problem.nn_lasso(X, y)).path(
        J.Plan(**kw, use_pallas=True))
    rt = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")).path(
        T.Plan(**kw, use_kernels=True))
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-5)


def test_nn_problem_and_plan_refusals():
    X, y = nn_problem()
    sess = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu"))
    assert sess.problem.spec is None and sess.problem.penalty == "nn_lasso"
    with pytest.raises(TypeError):
        sess.path(T.Plan(n_lambdas=4, use_kernels=True))
    gapsafe = sess.path(T.Plan(n_lambdas=4, screen="gapsafe"))
    assert gapsafe.stats.n_screens > 0 and (gapsafe.betas >= 0).all()
    with pytest.raises(ValueError, match="not valid"):
        sess.path(T.Plan(n_lambdas=4, screen="tlfre"))
    with pytest.raises(ValueError, match="per-fold"):
        sess.cv(T.Plan(n_lambdas=4, center="per-fold"))
    with pytest.raises(ValueError, match="SGL-only"):
        sess.path(T.Plan(n_lambdas=4, feature_weights=np.ones(160)))
    with pytest.raises(ValueError, match="identically zero"):
        T.nn_lasso_path_batched(_t(np.abs(X)), _t(-np.ones(len(y))),
                                n_lambdas=4)


def test_nn_lasso_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = nn_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Problem.nn_lasso(X, y)


def test_synthetic_nn_copies_the_benchmark_generator():
    from benchmarks import data_synth as ref_synth
    from repro_torch.data_synth import synthetic_nn
    for kind in (1, 2):
        got = synthetic_nn(kind, N=20, p=30, seed=kind)
        want = ref_synth.synthetic_nn(kind, N=20, p=30, seed=kind)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

