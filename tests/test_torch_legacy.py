"""The port's per-lambda driver (``engine='legacy'``) and single-lambda API
against the live JAX reference on the same numpy problems.

Tolerances:

* Paths, float64 at ``tol=1e-13``: betas within 1e-8, ``kept_features``
  and ``kept_groups`` equal, total FISTA iterations within 10% (the
  Lipschitz estimates differ in their last digits; see
  ``tests/test_torch_path.py``).  Unscreened SGL paths use N >= p: with
  N < p the reference's own unscreened betas move by about 1e-7.  The
  port's legacy driver against its batched engine: betas within 1e-8, as
  in ``tests/test_path_engine.py``.
* The single-lambda API, float64: screen keep masks equal, the
  Theorem-15/16 sups, ball centers and radii within 1e-12; ``solve_sgl``
  / ``solve_nn_lasso`` with the same ``lipschitz`` take equal iterations,
  betas within 1e-8; the Gap-Safe ball holds the exact dual optimum
  (distance <= radius * (1 + 1e-6)); rejection ratios equal.  Float32
  through the kernel route (the plain versions on the CPU): keep masks
  equal to the reference's float32 screen, sups within 1e-5 relative;
  path betas within 1e-5 of the reference's float32 legacy path (N > p).
* The shims: bitwise equal to the session's result, one warning per entry
  point.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import dpc as jdpc
from repro.core import fenchel as jfenchel
from repro_torch.core import problem as tproblem
from repro_torch.kernels import ops

F64 = dict(tol=1e-13, max_iter=200_000)


def make_problem(seed=0, N=40, G=15, n=4):
    """``tests/data/make_golden.py:make_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in range(3):
        idx = g * n
        beta[idx:idx + 2] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


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
    """``tests/test_path_engine.py:_nn_problem``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, active, replace=False)] = np.abs(
        rng.standard_normal(active))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


def ragged_problem(seed=5, N=50, G=30):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 8, size=G)]
    p = sum(sizes)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 8, replace=False)] = rng.standard_normal(8)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, sizes


def _assert_paths_match(rj, rt):
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    if rj.kept_groups is not None:
        np.testing.assert_array_equal(rt.kept_groups, rj.kept_groups)
    assert abs(int(rt.iters.sum()) - int(rj.iters.sum())) <= \
        0.1 * int(rj.iters.sum())
    assert rt.stats is None and rj.stats is None


SGL_PATHS = {
    "tlfre-golden-shape": (make_problem, {}, 0.9, dict(n_lambdas=12,
                                                       min_ratio=0.05)),
    "tlfre-ragged-frobenius": (ragged_problem, {}, 1.0,
                               dict(n_lambdas=8, specnorm_method="fro")),
    "none": (sgl_problem, dict(N=60, G=10), 1.0, dict(n_lambdas=8,
                                                      screen="none")),
}


@pytest.mark.parametrize("case", sorted(SGL_PATHS))
def test_sgl_legacy_path_matches_live_reference(case):
    make, make_kw, alpha, kw = SGL_PATHS[case]
    X, y, sizes = make(**make_kw)
    kw = dict(kw, **F64)
    rj = J.sgl_path(X, y, J.GroupSpec.from_sizes(sizes), alpha, **kw)
    rt = T.sgl_path(X, y, sizes, alpha, device="cpu", **kw)
    _assert_paths_match(rj, rt)
    assert np.abs(rt.betas).max() > 0.1
    if kw.get("screen") != "none":
        assert rt.kept_features[1] < X.shape[1]     # the screen removed some


@pytest.mark.parametrize("screen", ["dpc", "none"])
def test_nn_legacy_path_matches_live_reference(screen):
    X, y = nn_problem()
    kw = dict(n_lambdas=16, screen=screen, **F64)
    rj = J.nn_lasso_path(X, y, **kw)
    rt = T.nn_lasso_path(X, y, device="cpu", **kw)
    _assert_paths_match(rj, rt)
    assert (rt.betas >= 0).all() and rt.betas.max() > 0.1


@pytest.mark.parametrize("penalty", ["sgl", "nn"])
def test_legacy_gapsafe_runs_the_paper_screen(penalty):
    """The reference's legacy driver runs TLFre / DPC for any screen value
    but 'none', 'gapsafe' included; the port's does the same."""
    if penalty == "sgl":
        X, y, sizes = sgl_problem(G=20)
        run = lambda s: T.sgl_path(X, y, sizes, 1.0, n_lambdas=8,  # noqa
                                   screen=s, device="cpu", **F64)
        paper = "tlfre"
    else:
        X, y = nn_problem(p=120)
        run = lambda s: T.nn_lasso_path(X, y, n_lambdas=8,  # noqa: E731
                                        screen=s, device="cpu", **F64)
        paper = "dpc"
    a, b = run("gapsafe"), run(paper)
    np.testing.assert_array_equal(a.betas, b.betas)
    np.testing.assert_array_equal(a.kept_features, b.kept_features)


@pytest.mark.parametrize("weights", ["group", "group+feature"])
def test_session_legacy_matches_live_reference(weights):
    """``SGLSession.path(Plan(engine='legacy'))`` runs the per-lambda driver
    on the reweighted spec, as the reference's session does; a warm second
    call gives the same path."""
    X, y, sizes = make_problem(seed=9)
    wr = np.random.default_rng(20)
    extra = dict(group_weights=wr.uniform(0.5, 2.0, len(sizes)))
    if weights == "group+feature":
        extra["feature_weights"] = wr.uniform(0.5, 2.0, X.shape[1])
    kw = dict(engine="legacy", n_lambdas=8, min_ratio=0.05, **F64, **extra)
    rj = J.SGLSession(J.Problem.sgl(X, y, J.GroupSpec.from_sizes(sizes))
                      ).path(J.Plan(**kw))
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    rt = sess.path(T.Plan(**kw))
    _assert_paths_match(rj, rt)
    assert np.abs(rt.betas).max() > 0.1
    again = sess.path(T.Plan(**kw))
    np.testing.assert_array_equal(again.betas, rt.betas)
    assert sess.stats.n_segments == 0 and sess.stats.buckets == []


@pytest.mark.parametrize("screen", ["tlfre", "gapsafe", "none"])
def test_sgl_legacy_matches_batched_engine(screen):
    """``tests/test_path_engine.py:test_sgl_engine_parity`` on the port."""
    X, y, sizes = sgl_problem()
    kw = dict(n_lambdas=16, screen=screen, device="cpu", **F64)
    tproblem._WARNED.add("sgl_path(engine='batched')")
    res_b = T.sgl_path(X, y, sizes, 1.0, engine="batched", min_bucket=32,
                       **kw)
    res_l = T.sgl_path(X, y, sizes, 1.0, **kw)
    np.testing.assert_allclose(res_b.betas, res_l.betas, atol=1e-8)
    assert res_b.stats.n_segments < 16 and res_l.stats is None


@pytest.mark.parametrize("screen", ["dpc", "gapsafe", "none"])
def test_nn_legacy_matches_batched_engine(screen):
    """``tests/test_path_engine.py:test_nn_engine_parity`` on the port."""
    X, y = nn_problem()
    kw = dict(n_lambdas=16, device="cpu", **F64)
    tproblem._WARNED.add("nn_lasso_path(engine='batched')")
    res_b = T.nn_lasso_path(X, y, screen=screen, engine="batched",
                            min_bucket=32, **kw)
    res_l = T.nn_lasso_path(X, y, screen="dpc" if screen == "gapsafe"
                            else screen, **kw)
    np.testing.assert_allclose(res_b.betas, res_l.betas, atol=1e-8)


def test_legacy_accepts_custom_grid_with_the_endpoint():
    """``tests/test_path_engine.py:test_engine_accepts_custom_lambda_grid``
    on the port: a grid that holds ``lam_max`` gives a zero first row."""
    X, y, sizes = sgl_problem(seed=11, G=20, n=5)
    spec = T.GroupSpec.from_sizes(sizes, device="cpu")
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    lam_max = float(T.lambda_max_sgl(spec, Xt.T @ yt, 1.0)[0])
    lambdas = lam_max * np.asarray([1.0, 0.7, 0.4, 0.2, 0.1])
    tproblem._WARNED.add("sgl_path(engine='batched')")
    res_b = T.sgl_path(X, y, spec, 1.0, lambdas=lambdas, tol=1e-13,
                       engine="batched", min_bucket=32, device="cpu")
    res_l = T.sgl_path(X, y, spec, 1.0, lambdas=lambdas, tol=1e-13,
                       device="cpu")
    np.testing.assert_allclose(res_b.betas, res_l.betas, atol=1e-8)
    assert np.all(res_l.betas[0] == 0.0) and res_l.iters[0] == 0
    assert res_l.kept_features[0] == 0
    assert np.abs(res_l.betas[-1]).max() > 0.1


def test_legacy_kernel_route_on_the_cpu(monkeypatch):
    """Float32 with ``use_kernels=True`` on the CPU (the plain versions):
    ``xtv`` once a screen and once a solved row, ``screen_norms`` once a
    screen, ``sgl_prox`` once a FISTA iteration; betas as the reference's
    float32 legacy path's (N > p)."""
    calls = {"xtv": 0, "sgl_prox": 0, "screen_norms_gather": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _name=name, _orig=orig):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(ops, name, counted)
    X, y, sizes = make_problem(seed=4, N=80)
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(n_lambdas=8, min_ratio=0.05, tol=1e-6, safety=1e-4,
              max_iter=20000)
    rj = J.sgl_path(X, y, J.GroupSpec.from_sizes(sizes), 1.0, **kw)
    rt = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")).path(
        T.Plan(engine="legacy", use_kernels=True, **kw))
    screens = int((rt.lambdas < rt.lam_max * (1 - 1e-12)).sum())
    solved = int((rt.kept_features > 0).sum())
    assert calls["xtv"] == screens + solved > screens > 0
    assert calls["screen_norms_gather"] == screens
    assert calls["sgl_prox"] == int(rt.iters.sum()) > 0
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-5)


# ---------------------------------------------------------------------------
# The single-lambda API
# ---------------------------------------------------------------------------

def _ball_inputs(weighted, dtype=np.float64):
    """(X, y, sizes, spec kwargs, lam, lam_max): a Theorem-12 ball from
    lambda_max to 0.6 lambda_max, on a problem whose screen keeps some
    groups and drops others."""
    X, y, sizes = sgl_problem(seed=13, N=40, G=20, n=4)
    kw = {}
    if weighted:
        wr = np.random.default_rng(3)
        kw = dict(weights=wr.uniform(0.5, 2.0, len(sizes)),
                  feature_weights=wr.uniform(0.5, 2.0, X.shape[1]))
    return X.astype(dtype), y.astype(dtype), sizes, kw


def _both_balls(X, y, jspec, tspec, frac):
    """The reference's and the port's Theorem-12 balls at ``frac *
    lam_max`` from the exact dual at lam_max."""
    out = []
    for M, spec, arr in ((J, jspec, jnp.asarray),
                         (T, tspec, torch.as_tensor)):
        Xa, ya = arr(X), arr(y)
        lam_max_a, g_star = M.lambda_max_sgl(spec, Xa.T @ ya, 1.0)
        lam_max = float(lam_max_a)
        theta = ya / lam_max
        n_vec = M.normal_vector_sgl(Xa, ya, spec, lam_max, lam_max, theta,
                                    g_star)
        ball = M.estimate_dual_ball(ya, frac * lam_max, lam_max, theta,
                                    n_vec)
        out.append((Xa, ball))
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_tlfre_screen_matches_live_reference(weighted):
    X, y, sizes, kw = _ball_inputs(weighted)
    jspec = J.GroupSpec.from_sizes(sizes, **kw)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu", **kw)
    (Xj, bj), (Xt, bt) = _both_balls(X, y, jspec, tspec, 0.6)
    np.testing.assert_allclose(bt.center.numpy(), np.asarray(bj.center),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(bt.radius), float(bj.radius),
                               rtol=1e-12)
    rj = J.tlfre_screen(Xj, jspec, 1.0, bj, J.column_norms(Xj),
                        J.group_spectral_norms(Xj, jspec))
    rt = T.tlfre_screen(Xt, tspec, 1.0, bt, T.column_norms(Xt),
                        torch.as_tensor(np.array(
                            J.group_spectral_norms(Xj, jspec))))
    for f in ("group_keep", "feat_keep"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    for f in ("s_sup", "t_sup"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)),
                                   rtol=1e-12, atol=1e-12)
    gk = rt.group_keep.numpy()
    assert 0 < gk.sum() < len(sizes)
    assert [int(v) for v in T.screen_stats(tspec, rt)] == \
        [int(v) for v in J.screen_stats(jspec, rj)]
    assert T.rejection_ratios_sgl(tspec, np.zeros(X.shape[1]), rt.group_keep,
                                  rt.feat_keep) == \
        J.rejection_ratios_sgl(jspec, np.zeros(X.shape[1]),
                               np.asarray(rj.group_keep),
                               np.asarray(rj.feat_keep))


def test_tlfre_screen_kernel_route_matches_reference_float32():
    """``use_kernels=True`` on the CPU runs ``xtv`` and ``screen_norms``
    through their plain versions: the same keep masks as the reference's
    float32 screen."""
    X, y, sizes, _ = _ball_inputs(False)
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    (_, bj), (_, bt) = _both_balls(X, y, jspec, tspec, 0.6)
    X32 = X.astype(np.float32)
    cn = np.linalg.norm(X, axis=0).astype(np.float32)
    gs = np.asarray(J.group_spectral_norms(jnp.asarray(X), jspec),
                    dtype=np.float32)
    c32 = np.asarray(bj.center, dtype=np.float32)
    r32 = np.float32(float(bj.radius))
    rj = J.tlfre_screen(jnp.asarray(X32), jspec, 1.0,
                        J.DualBall(jnp.asarray(c32), jnp.asarray(r32)),
                        jnp.asarray(cn), jnp.asarray(gs), safety=1e-6)
    rt = T.tlfre_screen(torch.as_tensor(X32), tspec, 1.0,
                        T.DualBall(torch.as_tensor(c32),
                                   torch.as_tensor(r32)),
                        torch.as_tensor(cn), torch.as_tensor(gs),
                        safety=1e-6, use_kernels=True)
    assert rt.s_sup.dtype == torch.float32
    for f in ("group_keep", "feat_keep"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    for f in ("s_sup", "t_sup"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(TypeError):
        T.tlfre_screen(torch.as_tensor(X), tspec, 1.0, bt,
                       torch.as_tensor(cn.astype(np.float64)),
                       torch.as_tensor(gs.astype(np.float64)),
                       use_kernels=True)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dpc_screen_and_nn_ball_match_live_reference(use_kernels):
    X, y = nn_problem(N=40, p=120)
    dt = np.float32 if use_kernels else np.float64
    out = []
    for M, arr in ((jdpc, jnp.asarray), (T, torch.as_tensor)):
        Xa, ya = arr(X), arr(y)
        lam_max_a, i_star = M.lambda_max_nn(Xa.T @ ya)
        lam_max = float(lam_max_a)
        theta = ya / lam_max
        n_vec = M.normal_vector_nn(Xa, ya, lam_max, lam_max, theta, i_star)
        out.append(M.estimate_dual_ball_nn(ya, 0.5 * lam_max, lam_max,
                                           theta, n_vec))
    bj, bt = out
    np.testing.assert_allclose(bt.center.numpy(), np.asarray(bj.center),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(bt.radius), float(bj.radius),
                               rtol=1e-12)
    c, r, cn = (np.array(bj.center, dt), dt(float(bj.radius)),
                np.linalg.norm(X, axis=0).astype(dt))
    kj = J.dpc_screen(jnp.asarray(X.astype(dt)), J.DualBall(
        jnp.asarray(c), jnp.asarray(r)), jnp.asarray(cn), safety=1e-6)
    kt = T.dpc_screen(torch.as_tensor(X.astype(dt)), T.DualBall(
        torch.as_tensor(c), torch.as_tensor(r)), torch.as_tensor(cn),
        safety=1e-6, use_kernels=use_kernels)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < int(kt.sum()) < X.shape[1]
    xt = torch.as_tensor(X).T @ bt.center
    assert bool(T.nn_dual_feasible(xt / xt.max())) and \
        not bool(T.nn_dual_feasible(2.0 * xt / xt.max()))
    assert bool(T.nn_dual_feasible(xt / xt.max())) == \
        bool(jdpc.nn_dual_feasible(jnp.asarray(xt.numpy() / float(xt.max()))))


def test_solve_sgl_and_nn_lasso_match_live_reference():
    """With the same ``lipschitz`` the solvers take equal iterations."""
    X, y, sizes = sgl_problem(seed=2, N=40, G=10, n=4)
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    L = float(np.linalg.norm(X, 2) ** 2)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    lam = 0.3 * float(J.lambda_max_sgl(jspec, jnp.asarray(X.T @ y), 1.0)[0])
    kw = dict(tol=1e-11, max_iter=50_000, check_every=10)
    rj = J.solve_sgl(jnp.asarray(X), jnp.asarray(y), jspec, lam, 1.0, L, **kw)
    rt = T.solve_sgl(Xt, yt, tspec, lam, 1.0, L, **kw)
    assert rt.iters == int(rj.iters) > 10
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-8)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta),
                               atol=1e-8)
    # warm start from the solution: one gap check
    warm = T.solve_sgl(Xt, yt, tspec, lam, 1.0, L, rt.beta, **kw)
    assert warm.iters == 10
    with pytest.raises(TypeError):
        T.solve_sgl(Xt, yt, tspec, lam, 1.0, L, use_kernels=True, **kw)
    # the kernel route on the CPU (the fused prox's plain version), f32
    k32 = T.solve_sgl(Xt.float(), yt.float(), tspec, lam, 1.0, L,
                      use_kernels=True, tol=1e-6, max_iter=50_000)
    p32 = T.solve_sgl(Xt.float(), yt.float(), tspec, lam, 1.0, L, tol=1e-6,
                      max_iter=50_000)
    assert k32.iters == p32.iters
    np.testing.assert_allclose(k32.beta.numpy(), p32.beta.numpy(),
                               atol=1e-5)

    Xn, yn = nn_problem(N=40, p=60)
    Ln = float(np.linalg.norm(Xn, 2) ** 2)
    lam_n = 0.3 * float(np.max(Xn.T @ yn))
    nj = J.solve_nn_lasso(jnp.asarray(Xn), jnp.asarray(yn), lam_n, Ln, **kw)
    nt = T.solve_nn_lasso(torch.as_tensor(Xn), torch.as_tensor(yn), lam_n,
                          Ln, **kw)
    assert nt.iters == int(nj.iters) > 10
    np.testing.assert_allclose(nt.beta.numpy(), np.asarray(nj.beta),
                               atol=1e-8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gap_safe_ball_contains_optimum(seed):
    """``tests/test_screening_safety.py:test_gap_safe_ball_contains_optimum``
    on the port; the ball itself equals the reference's on the same
    inputs, with and without the ``gamma`` scaling."""
    X, y, sizes = sgl_problem(seed=seed, N=30, G=10, n=3)
    spec = T.GroupSpec.from_sizes(sizes, device="cpu")
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    lam = 0.4 * float(T.lambda_max_sgl(spec, Xt.T @ yt, 1.0)[0])
    L = T.spectral_norm(Xt) ** 2
    rough = T.solve_sgl(Xt, yt, spec, lam, 1.0, L, tol=1e-3, max_iter=500)
    p_val = T.sgl_primal_objective(Xt, yt, rough.beta, spec, lam, 1.0)
    d_val = T.sgl_dual_objective(yt, rough.theta, lam)
    ball = T.gap_safe_ball(rough.theta, p_val, d_val, lam)
    exact = T.solve_sgl(Xt, yt, spec, lam, 1.0, L, tol=1e-13,
                        max_iter=100_000)
    dist = float(torch.linalg.vector_norm(exact.theta - ball.center))
    assert 0 < dist <= float(ball.radius) * (1 + 1e-6)
    jspec = J.GroupSpec.from_sizes(sizes)
    bj = jnp.asarray(rough.beta.numpy())
    assert abs(float(p_val) - float(J.sgl_primal_objective(
        jnp.asarray(X), jnp.asarray(y), bj, jspec, lam, 1.0))) <= \
        1e-12 * abs(float(p_val))
    assert abs(float(d_val) - float(J.sgl_dual_objective(
        jnp.asarray(y), jnp.asarray(rough.theta.numpy()), lam))) <= \
        1e-12 * abs(float(d_val))
    for gamma in (1.0, 0.25):
        gj = J.gap_safe_ball(jnp.asarray(rough.theta.numpy()), float(p_val),
                             float(d_val), lam, gamma=gamma)
        gt = T.gap_safe_ball(rough.theta, p_val, d_val, lam, gamma=gamma)
        np.testing.assert_allclose(float(gt.radius), float(gj.radius),
                                   rtol=1e-12)


def test_rejection_ratio_bookkeeping():
    """``tests/test_screening_safety.py:test_rejection_ratio_bookkeeping``
    on the port, against the reference's numbers."""
    sizes = [4] * 10
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    beta = np.zeros(40)
    beta[:4] = 1.0
    gk = np.ones(10, bool)
    gk[2:] = False
    fk = np.repeat(gk, 4)
    fk[5] = False                       # one extra layer-2 discard
    r1, r2 = T.rejection_ratios_sgl(tspec, beta, torch.as_tensor(gk), fk)
    assert (r1, r2) == J.rejection_ratios_sgl(jspec, beta, gk, fk)
    assert abs(r1 - 32 / 36) < 1e-12 and abs(r2 - 1 / 36) < 1e-12


def test_fenchel_and_corollary10_match_live_reference():
    X, y, sizes = ragged_problem(seed=8, N=30, G=12)
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device="cpu")
    xty = X.T @ y
    xj, xt = jnp.asarray(xty), torch.as_tensor(xty)
    l2m = float(T.lambda2_max(xt))
    assert l2m == float(J.lambda2_max(xj))
    lam2 = 0.4 * l2m
    l1m = float(T.lambda1_max(tspec, xt, lam2))
    assert abs(l1m - float(J.lambda1_max(jspec, xj, lam2))) <= 1e-12 * l1m
    # Corollary 10: y is dual feasible for lam1 >= lambda1_max(lam2)
    norms = T.group_norms(tspec, T.shrink(xt, lam2)).numpy()
    w = tspec.weights.numpy()
    assert np.all(norms <= l1m * w * (1 + 1e-12))
    assert np.any(norms > 0.999 * l1m * w)
    for gamma in (1.0, 0.5):
        pj, sj = J.dual_decompose(xj, gamma)
        pt, st = T.dual_decompose(xt, gamma)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_allclose((pt + st).numpy(), xty, rtol=1e-15)
        np.testing.assert_array_equal(T.proj_binf(xt, gamma).numpy(),
                                      np.asarray(J.proj_binf(xj, gamma)))
    np.testing.assert_array_equal(T.group_inf_norms(tspec, xt).numpy(),
                                  np.asarray(jfenchel.group_inf_norms(jspec, xj)))


@pytest.mark.parametrize("feature_weights", [False, True])
def test_group_spec_subset_matches_live_reference(feature_weights):
    rng = np.random.default_rng(6)
    sizes = [3, 1, 4, 2, 5]
    kw = dict(weights=rng.uniform(0.5, 2.0, 5))
    if feature_weights:
        kw["feature_weights"] = rng.uniform(0.5, 2.0, 15)
    keep = rng.random(15) < 0.5
    keep[3] = False                     # group 1 (one feature) drops out
    sj, cj = J.GroupSpec.from_sizes(sizes, **kw).subset(keep)
    st, ct = T.GroupSpec.from_sizes(sizes, device="cpu", **kw).subset(keep)
    np.testing.assert_array_equal(ct, cj)
    for f in ("sizes", "starts", "group_ids", "weights", "pad_index",
              "pad_mask", "feature_weights"):
        a, b = getattr(st, f), getattr(sj, f)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.num_groups == sj.num_groups and st.device.type == "cpu"


# ---------------------------------------------------------------------------
# Shims, refusals, EngineStats.merge
# ---------------------------------------------------------------------------

def _deprecations(run):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = [run(), run()]
    return out, [w for w in rec if issubclass(w.category,
                                              DeprecationWarning)]


def test_sgl_shims_warn_once_and_match_the_session():
    """``tests/test_session.py:test_legacy_entry_points_warn_once_and_match_
    bitwise`` on the port."""
    X, y, sizes = sgl_problem(seed=3, G=20)
    kw = dict(n_lambdas=10, tol=1e-10, max_iter=100_000)
    tproblem._WARNED.clear()
    (p1, p2), deps = _deprecations(lambda: T.sgl_path(
        X, y, sizes, 1.0, engine="batched", device="cpu", **kw))
    assert len(deps) == 1 and "SGLSession.path" in str(deps[0].message)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    np.testing.assert_array_equal(p1.betas, sess.path(T.Plan(**kw)).betas)
    np.testing.assert_array_equal(p1.betas, p2.betas)
    (c1, _), deps = _deprecations(lambda: T.sgl_cv(
        X, y, sizes, 1.0, n_folds=3, device="cpu", **kw))
    assert len(deps) == 1 and "SGLSession.cv" in str(deps[0].message)
    new_cv = sess.cv(T.Plan(n_folds=3, **kw))
    np.testing.assert_array_equal(c1.fold_betas, new_cv.fold_betas)
    np.testing.assert_array_equal(c1.mean_mse, new_cv.mean_mse)
    assert c1.best_lambda == new_cv.best_lambda
    assert c1.fold_iters is not None


def test_nn_shims_warn_once_and_match_the_session():
    """``tests/test_session.py:test_nn_shims_match_bitwise`` on the port."""
    X, y = nn_problem(seed=5, N=40, p=96, active=6)
    kw = dict(n_lambdas=8, tol=1e-10, max_iter=100_000)
    tproblem._WARNED.clear()
    (c1, _), deps = _deprecations(lambda: T.nn_lasso_cv(
        X, y, n_folds=3, device="cpu", **kw))
    assert len(deps) == 1
    sess = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu"))
    new = sess.cv(T.Plan(n_folds=3, **kw))
    np.testing.assert_array_equal(c1.fold_betas, new.fold_betas)
    assert c1.best_lambda == new.best_lambda
    (p1, _), deps = _deprecations(lambda: T.nn_lasso_path(
        X, y, engine="batched", device="cpu", **kw))
    assert len(deps) == 1
    np.testing.assert_array_equal(p1.betas, sess.path(T.Plan(**kw)).betas)


@pytest.mark.parametrize("call,error", [
    (lambda X, y, s: T.sgl_path(X, y, s, 1.0, n_lambdas=4, min_bucket=32,
                                device="cpu"), TypeError),
    (lambda X, y, s: T.nn_lasso_path(X, y, n_lambdas=4, margin=0.5,
                                     device="cpu"), TypeError),
    (lambda X, y, s: T.sgl_path(X, y, s, 1.0, engine="nope",
                                device="cpu"), ValueError),
    (lambda X, y, s: T.nn_lasso_path(X, y, engine="nope", device="cpu"),
     ValueError),
    (lambda X, y, s: T.SGLSession(T.Problem.sgl_logistic(
        X, (y > 0).astype(float), s, device="cpu")).path(
            T.Plan(engine="legacy", n_lambdas=4)), ValueError),
    (lambda X, y, s: T.SGLSession(T.Problem.sgl(X, y, s, device="cpu")).path(
        T.Plan(engine="legacy", n_lambdas=4, feature_shards=2)), ValueError),
    (lambda X, y, s: T.SGLSession(T.Problem.sgl(X, y, s, device="cpu")).path(
        T.Plan(engine="bogus", n_lambdas=4)), ValueError),
    (lambda X, y, s: T.SGLSession(T.Problem.sgl(X, y, s, device="cpu")).path(
        T.Plan(engine="legacy", n_lambdas=4, use_kernels=True)), TypeError),
])
def test_legacy_refusals(call, error):
    X, y, sizes = sgl_problem(G=10)
    with pytest.raises(error):
        call(X, y, sizes)


def test_legacy_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, sizes = sgl_problem(G=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.sgl_path(X, y, sizes, 1.0, n_lambdas=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.nn_lasso_path(X, y, n_lambdas=4)


def test_engine_stats_merge():
    """``tests/test_session.py:test_engine_stats_merge`` on the port, plus
    the port's ``fista_iters``; a session's aggregate keeps no buckets."""
    a = T.EngineStats(n_segments=1, n_screens=2, n_compilations=3,
                      n_rejected=4, fista_iters=5, buckets=[(64, 16, 8, 8)])
    b = T.EngineStats(n_segments=10, n_screens=20, n_compilations=30,
                      n_rejected=40, fista_iters=50,
                      buckets=[(128, 32, 4, 2)])
    a.merge(b)
    assert (a.n_segments, a.n_screens, a.n_compilations, a.n_rejected,
            a.fista_iters) == (11, 22, 33, 44, 55)
    assert a.buckets == [(64, 16, 8, 8), (128, 32, 4, 2)]
    a.merge(b, buckets=False)
    assert len(a.buckets) == 2 and a.n_segments == 21
    X, y, sizes = sgl_problem(G=10)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    res = sess.path(T.Plan(n_lambdas=6, tol=1e-8))
    assert res.stats.buckets and sess.stats.buckets == []
    assert sess.stats.n_segments == res.stats.n_segments > 0
