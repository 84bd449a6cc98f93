"""The port's Gap-Safe screen (``screen='gapsafe'``) against the live JAX
reference on the same numpy problems: the SGL and nonnegative-Lasso paths,
fold-batched CV for both penalties, and the rules and radii alone.

Tolerances:

* float64 at ``tol=1e-13``: betas (and CV ``mse_path``) within 1e-8, and
  the engine's structure equal: segments, screens, compilations,
  rejections, buckets, kept sets (and, under ``schedule='lockstep'``,
  per-fold sweep launches).  Total FISTA iterations within 10% (the
  Lipschitz estimates differ in their last digits; see
  ``tests/test_torch_path.py``).  Under the elastic schedule only betas,
  MSE and the selection are held.
* The rules and radii alone, float64: keep masks equal, radii within
  ``rtol=1e-12``.  Float32 through the kernel route (the plain versions on
  the CPU): keep masks equal to the reference's ``use_pallas=True`` rules
  on the broadcast center, path betas within 1e-5 (N > p), CV betas within
  5e-5 (the bar of ``tests/test_fold_elastic.py``'s kernel-route cases).
* The Gap-Safe ball holds the exact dual optimum: distance <= radius *
  (1 + 1e-6), as in ``tests/test_screening_safety.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from conftest import rand_cases

import repro.core as J
import repro_torch.core as T
from repro.core import dpc as jdpc
from repro.core import screening as jscr
from repro_torch import convert
from repro_torch.core import screening as tscr
from repro_torch.kernels import ops

F64 = dict(tol=1e-13, max_iter=200_000)


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


def sgl_problem(seed=7, N=60, G=40, n=6):
    """``tests/test_path_engine.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 5, replace=False):
        beta[g * n + rng.choice(n, 3, replace=False)] = rng.standard_normal(3)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


def nn_problem(seed=3, N=50, p=240, active=15):
    """``tests/test_path_engine.py:_nn_problem`` (p=160 with 10 active is
    ``tests/test_cv.py:_nn_problem``)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, active, replace=False)] = np.abs(
        rng.standard_normal(active))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


def _sessions(penalty, X, y, sizes=None):
    if penalty == "sgl":
        jspec = J.GroupSpec.from_sizes(sizes)
        return (J.SGLSession(J.Problem.sgl(X, y, jspec)),
                T.SGLSession(convert.problem(X, y, _children(jspec),
                                             device="cpu")))
    return (J.SGLSession(J.Problem.nn_lasso(X, y)),
            T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")))


def _assert_counters_equal(rj, rt, fields=("n_segments", "n_screens",
                                           "n_compilations", "n_rejected",
                                           "n_pallas_screens", "buckets")):
    for f in fields:
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f


# ---------------------------------------------------------------------------
# The paths (tests/test_path_engine.py:49 and :71, screen='gapsafe')
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_gapsafe_path_f64_matches_live_reference(penalty):
    if penalty == "sgl":
        X, y, sizes = sgl_problem()
    else:
        (X, y), sizes = nn_problem(), None
    kw = dict(F64, n_lambdas=16, min_bucket=32, screen="gapsafe")
    sj, st = _sessions(penalty, X, y, sizes)
    rj, rt = sj.path(J.Plan(**kw)), st.path(T.Plan(**kw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.1
    _assert_counters_equal(rj, rt)
    assert rt.stats.n_screens > 0 and rt.stats.n_pallas_screens == 0
    assert abs(int(rt.iters.sum()) - int(rj.iters.sum())) <= \
        0.1 * int(rj.iters.sum())
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert rt.kept_features[1] < X.shape[1]
    warm = st.path(T.Plan(**kw))
    assert warm.stats.n_compilations == 0
    np.testing.assert_array_equal(warm.betas, rt.betas)


def test_gapsafe_path_f32_kernel_route_matches_reference_pallas_route():
    """The float32 SGL path through the kernel route (each Gap-Safe screen's
    statistics on the (1, p) row through ``screen_norms_gather``'s plain
    version) against the reference's ``use_pallas=True`` interpret
    route."""
    rng = np.random.default_rng(120)
    G, n, N = 4, 5, 60
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    beta[:2] = np.abs(rng.standard_normal(2))
    beta[n:n + 2] = np.abs(rng.standard_normal(2))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(n_lambdas=8, min_ratio=0.05, tol=1e-6, safety=1e-4,
              max_iter=20000, min_bucket=16, screen="gapsafe")
    sj, st = _sessions("sgl", X, y, [n] * G)
    rj = sj.path(J.Plan(**kw, use_pallas=True))
    rows = []
    orig = ops.screen_norms_gather
    try:
        ops.screen_norms_gather = lambda C, *a: (rows.append(C.shape[0]),
                                                 orig(C, *a))[1]
        rt = st.path(T.Plan(**kw, use_kernels=True))
    finally:
        ops.screen_norms_gather = orig
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-5)
    assert rt.stats.n_pallas_screens == rj.stats.n_pallas_screens == \
        rt.stats.n_screens > 0
    assert rt.stats.n_compilations == rj.stats.n_compilations
    # two statistics calls a screen: TLFre's on the grid, Gap-Safe's on one
    # row
    assert len(rows) == 2 * rt.stats.n_screens and rows[1::2] == \
        [1] * rt.stats.n_screens and min(rows[0::2]) > 1


# ---------------------------------------------------------------------------
# Cross-validation (tests/test_cv.py:76 and :170, screen='gapsafe')
# ---------------------------------------------------------------------------

def cv_sgl_problem(seed=7, N=60, G=30, n=5):
    """``tests/test_cv.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 4, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


def _cv_sessions(penalty):
    if penalty == "sgl":
        X, y, sizes = cv_sgl_problem()
        return _sessions("sgl", X, y, sizes)
    X, y = nn_problem(p=160, active=10)
    return _sessions("nn_lasso", X, y)


CV64 = dict(F64, n_folds=3, n_lambdas=10, min_bucket=32, screen="gapsafe")


def _assert_same_cv(rt, rj, atol=1e-8):
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.fold_betas, rj.fold_betas, atol=atol)
    assert np.abs(rt.fold_betas).max() > 0.1
    np.testing.assert_allclose(rt.mse_path, rj.mse_path, atol=atol)
    np.testing.assert_allclose(rt.mean_mse, rj.mean_mse, atol=atol)
    assert rt.best_index == rj.best_index
    assert rt.index_1se == rj.index_1se


@pytest.mark.parametrize("case", ["sgl-global", "sgl-per-fold", "nn"])
def test_gapsafe_cv_lockstep_matches_live_reference(case):
    penalty = "nn_lasso" if case == "nn" else "sgl"
    extra = dict(center="per-fold") if case == "sgl-per-fold" else {}
    sj, st = _cv_sessions(penalty)
    kw = dict(CV64, schedule="lockstep", **extra)
    rj, rt = sj.cv(J.Plan(**kw)), st.cv(T.Plan(**kw))
    _assert_same_cv(rt, rj)
    _assert_counters_equal(rj, rt)
    np.testing.assert_array_equal(rt.stats.fold_sweeps, rj.stats.fold_sweeps)
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert abs(int(rt.fold_iters.sum()) - int(rj.fold_iters.sum())) <= \
        0.1 * int(rj.fold_iters.sum())


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_gapsafe_cv_elastic_matches_live_reference(penalty):
    sj, st = _cv_sessions(penalty)
    rj, rt = sj.cv(J.Plan(**CV64)), st.cv(T.Plan(**CV64))
    _assert_same_cv(rt, rj)
    assert rt.stats.n_screens > 0 and rt.stats.n_pallas_screens == 0


RAGGED_SIZES = [3, 7, 1, 5, 4, 9, 2, 6, 5, 3, 8, 4, 5, 7, 2, 6]   # p = 77


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_gapsafe_cv_f32_kernel_route_matches_reference_pallas_route(penalty):
    """``tests/test_fold_elastic.py:193`` and ``:211`` (ragged p = 77, two
    folds, 8 lambdas) through both kernel routes: the port's plain
    versions against the reference's interpret-mode kernels."""
    from repro.core.cv import _masks_from_folds, kfold_indices
    from repro.core.cv import nn_fold_paths as j_nn, sgl_fold_paths as j_sgl
    from repro.core.path import default_lambda_grid
    rng = np.random.default_rng(5 if penalty == "sgl" else 8)
    N, K = 40, 2
    p = sum(RAGGED_SIZES) if penalty == "sgl" else 77
    X = rng.standard_normal((N, p)).astype(np.float32)
    b = np.zeros(p)
    if penalty == "sgl":
        b[[0, 4, 11, 30, 55]] = rng.standard_normal(5)
    else:
        b[[1, 5, 40]] = np.abs(rng.standard_normal(3))
    y = (X @ b + 0.01 * rng.standard_normal(N)).astype(np.float32)
    masks = _masks_from_folds(kfold_indices(N, K), N)
    kw = dict(screen="gapsafe", tol=1e-6, max_iter=20000, safety=1e-5,
              min_bucket=16)
    Xt = torch.as_tensor(X)
    if penalty == "sgl":
        jspec = J.GroupSpec.from_sizes(RAGGED_SIZES)
        lam_max = float(J.lambda_max_sgl(jspec, jnp.asarray(X).T
                                         @ jnp.asarray(y), 1.0)[0])
        lambdas = default_lambda_grid(lam_max, 8, 0.05)
        bj, _, _, sj, _ = j_sgl(X, y, jspec, 1.0, masks, lambdas,
                                use_pallas=True, **kw)
        bt, _, _, st, _ = T.sgl_fold_paths(
            Xt, y, convert.group_spec(_children(jspec), device="cpu"), 1.0,
            masks, lambdas, use_kernels=True, **kw)
    else:
        lam_max = float(np.max(X.T @ y))
        lambdas = default_lambda_grid(lam_max, 8, 0.05)
        bj, _, _, sj, _ = j_nn(X, y, masks, lambdas, use_pallas=True, **kw)
        bt, _, _, st, _ = T.nn_fold_paths(Xt, y, masks, lambdas,
                                          use_kernels=True, **kw)
    assert st.n_pallas_screens == sj.n_pallas_screens == st.n_screens > 0
    np.testing.assert_allclose(bt, bj, atol=5e-5)


# ---------------------------------------------------------------------------
# The rules and radii alone
# ---------------------------------------------------------------------------

def _rule_inputs(seed, weighted, dtype=np.float64, L=6):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 7, size=12)]
    p = sum(sizes)
    gw = rng.uniform(0.5, 2.0, len(sizes)) if weighted else None
    fw = rng.uniform(0.5, 2.0, p) if weighted else None
    jspec = J.GroupSpec.from_sizes(sizes, weights=gw, feature_weights=fw)
    c = (rng.standard_normal(p) * 1.5).astype(dtype)
    radii = rng.uniform(0.0, 0.3, L).astype(dtype)
    col_n = rng.uniform(0.5, 2.0, p).astype(dtype)
    gspec = rng.uniform(0.5, 3.0, len(sizes)).astype(dtype)
    return jspec, c, radii, col_n, gspec


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("weighted", [False, True])
def test_gap_safe_rules_match_reference(weighted):
    jspec, c, radii, col_n, gspec = _rule_inputs(1, weighted)
    tspec = convert.group_spec(_children(jspec), device="cpu")
    gj, fj = jscr.gap_safe_screen_grid(jspec, 0.8, jnp.asarray(c),
                                       jnp.asarray(radii), jnp.asarray(col_n),
                                       jnp.asarray(gspec))
    gt, ft = T.gap_safe_screen_grid(tspec, 0.8, _t(c), _t(radii), _t(col_n),
                                    _t(gspec))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert 0 < int(ft.sum()) < ft.numel()


def test_gap_safe_rules_f32_kernel_route_reads_one_row():
    """Float32 with ``use_kernels``: the statistics of the one center row go
    through ``screen_norms_gather`` (its plain version on the CPU) and are
    expanded across the grid; the masks equal the reference's
    ``use_pallas=True`` rules on the center broadcast to (L, p)."""
    jspec, c, radii, col_n, gspec = _rule_inputs(2, False, np.float32, L=9)
    tspec = convert.group_spec(_children(jspec), device="cpu")
    gj, fj = jscr.gap_safe_screen_grid(jspec, 1.0, jnp.asarray(c),
                                       jnp.asarray(radii), jnp.asarray(col_n),
                                       jnp.asarray(gspec), use_pallas=True)
    shapes = []
    orig = ops.screen_norms_gather
    try:
        ops.screen_norms_gather = lambda C, *a: (shapes.append(tuple(
            C.shape)), orig(C, *a))[1]
        gt, ft = T.gap_safe_screen_grid(tspec, 1.0, _t(c), _t(radii),
                                        _t(col_n), _t(gspec),
                                        use_kernels=True)
    finally:
        ops.screen_norms_gather = orig
    assert shapes == [(1, tspec.num_features)]
    assert gt.shape == (9, tspec.num_groups)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    with pytest.raises(TypeError):
        T.gap_safe_screen_grid(tspec, 1.0, _t(c).double(), _t(radii),
                               _t(col_n), _t(gspec), use_kernels=True)


@pytest.mark.parametrize("weighted,kernels", [(False, False), (True, False),
                                              (False, True)])
def test_gap_safe_fold_rules_match_reference(weighted, kernels):
    """Fold-stacked rules, K = 3 centers: float64 (plain), or float32 with
    one ``screen_norms_folds`` call of K rows (its plain version)."""
    dtype = np.float32 if kernels else np.float64
    jspec, _, _, _, _ = _rule_inputs(3, weighted, dtype)
    rng = np.random.default_rng(4)
    K, L, p, G = 3, 5, jspec.num_features, jspec.num_groups
    c = (rng.standard_normal((K, p)) * 1.5).astype(dtype)
    radii = rng.uniform(0.0, 0.3, (K, L)).astype(dtype)
    col_n = rng.uniform(0.5, 2.0, (K, p)).astype(dtype)
    gspec = rng.uniform(0.5, 3.0, (K, G)).astype(dtype)
    tspec = convert.group_spec(_children(jspec), device="cpu")
    gj, fj = jscr.gap_safe_screen_grid_folds(
        jspec, 0.9, jnp.asarray(c), jnp.asarray(radii), jnp.asarray(col_n),
        jnp.asarray(gspec), use_pallas=kernels)
    gt, ft = T.gap_safe_screen_grid_folds(tspec, 0.9, _t(c), _t(radii),
                                          _t(col_n), _t(gspec),
                                          use_kernels=kernels)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_gap_safe_nn_rule_matches_reference():
    rng = np.random.default_rng(6)
    c = rng.standard_normal(50) * 0.8
    radii = rng.uniform(0.0, 0.5, 7)
    col_n = rng.uniform(0.5, 2.0, 50)
    want = jdpc.gap_safe_screen_grid_nn(jnp.asarray(c), jnp.asarray(radii),
                                        jnp.asarray(col_n))
    got = T.gap_safe_screen_grid_nn(_t(c), _t(radii), _t(col_n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gap_safe_grid_radii_match_reference():
    """Squared loss (``gap_safe_grid_radii``) and the loss-generic form for
    both losses: rtol 1e-12."""
    rng = np.random.default_rng(7)
    N = 30
    y = rng.standard_normal(N)
    lambdas = np.geomspace(2.0, 0.2, 9)
    theta = 0.2 * rng.standard_normal(N)
    fit = rng.standard_normal(N)
    resid, pen = y - fit, 1.7
    want = jscr.gap_safe_grid_radii(jnp.asarray(y), lambdas,
                                    jnp.asarray(theta), jnp.asarray(resid),
                                    pen)
    got = T.gap_safe_grid_radii(_t(y), _t(lambdas), _t(theta), _t(resid),
                                torch.tensor(pen, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    y01 = (y > 0).astype(float)
    for name, yy in (("squared", y), ("logistic", y01)):
        jl, tl = J.get_loss(name), T.get_loss(name)
        r_j = jl.residual(jnp.asarray(yy), jnp.asarray(fit))
        r_t = tl.residual(_t(yy), _t(fit))
        th = 0.05 * np.asarray(r_j)
        want = jscr.gap_safe_grid_radii_loss(
            jl, jnp.asarray(yy), lambdas, jnp.asarray(th), jnp.asarray(fit),
            r_j, pen)
        got = T.gap_safe_grid_radii_loss(
            tl, _t(yy), _t(lambdas), _t(th), _t(fit), r_t,
            torch.tensor(pen, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        assert (got.numpy() > 0).all()


@pytest.mark.parametrize("seed", rand_cases(6, ("int", 0, 10**6), seed=15))
def test_gap_safe_ball_contains_optimum(seed):
    """``tests/test_screening_safety.py:122`` on the port: a rough solve's
    feasible dual and gap give the ball ``||theta* - theta|| <=
    sqrt(2 gap)/lam`` (``gap_safe_grid_radii`` at one lambda), which holds
    the exact dual optimum."""
    rng = np.random.default_rng(seed)
    N, G, n = 30, 10, 3
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 3, replace=False):
        idx = np.arange(g * n, (g + 1) * n)
        beta[rng.choice(idx, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    X, y = _t(X), _t(y)
    spec = T.GroupSpec.from_sizes([n] * G, device="cpu")
    alpha = 1.0
    lam = 0.4 * float(T.lambda_max_sgl(spec, X.T @ y, alpha)[0])
    L = T.spectral_norm(X) ** 2
    zero = torch.zeros(p, dtype=torch.float64)
    rough = T.fista_sgl(X, y, spec, lam, alpha, L, zero, tol=1e-3,
                        max_iter=500)
    radius = T.gap_safe_grid_radii(
        y, torch.tensor([lam], dtype=torch.float64), rough.theta,
        y - X @ rough.beta, T.sgl_penalty(spec, rough.beta, alpha))[0]
    exact = T.fista_sgl(X, y, spec, lam, alpha, L, zero, tol=1e-13,
                        max_iter=100_000)
    assert bool(T.sgl_dual_feasible(spec, X.T @ rough.theta, alpha, 1e-12))
    dist = float(torch.linalg.vector_norm(exact.theta - rough.theta))
    assert dist <= float(radius) * (1 + 1e-6)


def test_unknown_screen_modes_raise():
    X, y, sizes = cv_sgl_problem()
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    with pytest.raises(ValueError, match="not valid"):
        sess.path(T.Plan(n_lambdas=4, screen="dpc"))
    with pytest.raises(ValueError, match="unknown screen"):
        T.sgl_path_batched(sess.problem.X, sess.problem.y,
                           sess.problem.spec, 1.0, n_lambdas=4,
                           screen="bogus")
