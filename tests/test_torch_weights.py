"""Adaptive group and feature weights in the port (``Plan(group_weights=...,
feature_weights=...)`` and ``GroupSpec.from_sizes(..., weights=...,
feature_weights=...)``) against the live JAX reference.

Tolerances:

* The weighted Lemma-9 roots, ``lambda_max`` and the feasibility margin:
  rtol 1e-12 in float64, 1e-5 in float32.
* float64 paths and CV at ``tol=1e-13``: betas (and ``mse_path``) within
  1e-8; segments, screens, compilations, rejections, buckets and kept sets
  equal (CV under ``schedule='lockstep'``, which also fixes the per-fold
  sweep launches).  The screened weighted path reproduces the unscreened
  one within 5e-6, the reference's own bar
  (``tests/test_screening_safety.py:230``).
* The plan overlay is the explicit weighted spec bit for bit.
* Float32 kernel route (plain versions on the CPU): each kernel is gated
  on the function it computes.  Group weights alone keep every kernel on;
  feature weights keep ``xtv`` (one call a row solved) and take the plain
  prox and screen statistics (the fused ones take one l1 threshold), as
  the reference's screens do.  ``n_compilations`` equals the reference's
  ``use_pallas=True`` count and betas agree within 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import lambda_max as jlm
from repro_torch import convert
from repro_torch.core import lambda_max as tlm

F64 = dict(tol=1e-13, max_iter=200_000)


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _weighted_spec(seed, sizes):
    rng = np.random.default_rng(seed)
    return J.GroupSpec.from_sizes(
        sizes, weights=rng.uniform(0.5, 2.0, len(sizes)),
        feature_weights=rng.uniform(0.5, 2.0, sum(sizes)))


# ---------------------------------------------------------------------------
# The parts: roots, lambda_max, feasibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_weighted_segment_roots_match_reference(dtype, rtol):
    rng = np.random.default_rng(11)
    G, n_max = 40, 7
    mask = rng.random((G, n_max)) < 0.8
    mask[:, 0] = True
    z = np.where(mask, np.abs(rng.standard_normal((G, n_max))) * 3, 0.0)
    w = np.where(mask, rng.uniform(0.3, 2.5, (G, n_max)), 0.0)
    z[3] = 0.0                                    # an all-zero row
    w[5] = np.where(mask[5], 1.0, 0.0)            # unit weights
    z, w = z.astype(dtype), w.astype(dtype)
    target_sq = rng.uniform(0.1, 4.0, G).astype(dtype)
    want = jlm._padded_segment_roots_w(jnp.asarray(z), jnp.asarray(w),
                                       jnp.asarray(target_sq))
    got = tlm._padded_segment_roots_w(_t(z), _t(w), _t(target_sq))
    assert got.dtype == _t(z).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)
    assert float(got[3]) == 0.0
    # unit weights: the unweighted roots
    np.testing.assert_allclose(
        float(got[5]), float(tlm._padded_segment_roots(
            _t(z[5:6]), _t(target_sq[5:6]))[0]), rtol=rtol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_lambda_max_is_exact_boundary(seed):
    """``tests/test_loss_generic.py:184`` on the port: at the weighted
    ``lambda_max`` (equal to the reference's) the all-zero solution is
    optimal; just below it is not."""
    rng = np.random.default_rng(seed)
    G, n, N = 8, 3, 40
    p = G * n
    X = rng.standard_normal((N, p))
    y = X[:, 0] + 0.1 * rng.standard_normal(N)
    jspec = J.GroupSpec.from_sizes([n] * G, weights=rng.uniform(0.5, 2.0, G),
                                   feature_weights=rng.uniform(0.5, 2.0, p))
    spec = convert.group_spec(_children(jspec), device="cpu")
    alpha = 0.7
    xty = X.T @ y
    lam_max = float(T.lambda_max_sgl(spec, _t(xty), alpha)[0])
    want = float(J.lambda_max_sgl(jspec, jnp.asarray(xty), alpha)[0])
    assert abs(lam_max - want) <= 1e-12 * want
    Xt, yt = _t(X), _t(y)
    L = float(T.spectral_norm(Xt)) ** 2
    zero = torch.zeros(p, dtype=torch.float64)
    above = T.fista_sgl(Xt, yt, spec, 1.001 * lam_max, alpha, L, zero,
                        tol=1e-12, max_iter=50_000)
    assert float(above.beta.abs().max()) == 0.0
    below = T.fista_sgl(Xt, yt, spec, 0.95 * lam_max, alpha, L, zero,
                        tol=1e-12, max_iter=50_000)
    assert float(below.beta.abs().max()) > 0.0


def test_weighted_dual_scaling_and_margin_match_reference():
    rng = np.random.default_rng(3)
    sizes = [int(s) for s in rng.integers(1, 6, size=15)]
    jspec = _weighted_spec(4, sizes)
    spec = convert.group_spec(_children(jspec), device="cpu")
    c = rng.standard_normal(sum(sizes)) * 2.0
    for alpha in (0.3, 1.0):
        np.testing.assert_allclose(
            float(T.dual_scaling_sgl(spec, _t(c), alpha)),
            float(J.dual_scaling_sgl(jspec, jnp.asarray(c), alpha)),
            rtol=1e-12)
        np.testing.assert_allclose(
            T.sgl_feasibility_margin(spec, _t(c), alpha).numpy(),
            np.asarray(J.sgl_feasibility_margin(jspec, jnp.asarray(c),
                                                alpha)), rtol=1e-12)
        # the scaled point is feasible, the margin's zero set is tight
        s = T.dual_scaling_sgl(spec, _t(c), alpha)
        assert bool(T.sgl_dual_feasible(spec, s * _t(c), alpha, 1e-12))
        np.testing.assert_allclose(
            float(T.sgl_feasibility_margin(spec, s * _t(c), alpha).max()),
            0.0, atol=1e-10)


def test_weighted_spec_round_trips_and_validates():
    jspec = _weighted_spec(5, [3, 1, 4, 2])
    spec = convert.group_spec(_children(jspec), device="cpu")
    np.testing.assert_array_equal(spec.weights.numpy(),
                                  np.asarray(jspec.weights))
    np.testing.assert_array_equal(spec.feature_weights.numpy(),
                                  np.asarray(jspec.feature_weights))
    direct = T.GroupSpec.from_sizes(
        [3, 1, 4, 2], weights=np.asarray(jspec.weights),
        feature_weights=np.asarray(jspec.feature_weights), device="cpu")
    for f in convert.SPEC_FIELDS:
        assert torch.equal(getattr(direct, f), getattr(spec, f)), f
    sub, col_idx = spec.bucketed_subset(np.asarray([1] * 4 + [0] * 6,
                                                   dtype=bool), 8, 4)
    np.testing.assert_array_equal(sub.feature_weights.numpy()[:4],
                                  np.asarray(jspec.feature_weights)[col_idx])
    assert (sub.feature_weights.numpy()[4:] == 1.0).all()
    with pytest.raises(ValueError, match="shape"):
        T.GroupSpec.from_sizes([2, 2], weights=[1.0], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        T.GroupSpec.from_sizes([2, 2], feature_weights=[1.0] * 3,
                               device="cpu")
    with pytest.raises(ValueError, match="positive"):
        T.GroupSpec.from_sizes([2, 2], feature_weights=[1, 0, 1, 1],
                               device="cpu")


# ---------------------------------------------------------------------------
# Paths and CV
# ---------------------------------------------------------------------------

def make_problem(seed=5, N=40, G=15, n=4):
    """``tests/data/make_golden.py:make_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in range(3):
        beta[g * n:g * n + 2] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


def test_plan_overlay_matches_explicit_weighted_spec():
    """``tests/test_loss_generic.py:84`` on the port: plan weights on a
    plain spec are the weights baked into the spec, bit for bit; and both
    match the reference within 1e-8."""
    X, y, sizes = make_problem()
    G, n = 15, 4
    rng = np.random.default_rng(6)
    gw = rng.uniform(0.5, 2.0, G)
    fw = rng.uniform(0.5, 2.0, G * n)
    base = dict(alpha=0.8, n_lambdas=10, min_ratio=0.1, tol=1e-10)
    plain = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    res_a = plain.path(T.Plan(**base, group_weights=gw, feature_weights=fw))
    spec_w = T.GroupSpec.from_sizes(sizes, weights=gw, feature_weights=fw,
                                    device="cpu")
    res_b = T.SGLSession(T.Problem.sgl(X, y, spec_w, device="cpu")).path(
        T.Plan(**base))
    np.testing.assert_array_equal(res_a.lambdas, res_b.lambdas)
    np.testing.assert_array_equal(res_a.betas, res_b.betas)
    ref = J.SGLSession(J.Problem.sgl(X, y, J.GroupSpec.uniform_groups(
        G, n))).path(J.Plan(**base, group_weights=gw, feature_weights=fw))
    np.testing.assert_allclose(res_a.lambdas, ref.lambdas, rtol=1e-12)
    np.testing.assert_allclose(res_a.betas, ref.betas, atol=1e-8)
    # the problem's own spec is untouched by the overlay
    assert plain.problem.spec.feature_weights is None


@pytest.mark.parametrize("seed,screen", [(s, sc) for s in (0, 1)
                                         for sc in ("tlfre", "gapsafe")])
def test_weighted_path_f64_matches_live_reference(seed, screen):
    """``tests/test_screening_safety.py:230``'s protocol (N=50, 20 groups of
    5, weights from ``uniform(0.5, 2.0)``) at tol 1e-13."""
    rng = np.random.default_rng(seed)
    N, G, n = 50, 20, 5
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    for g in rng.choice(G, 3, replace=False):
        idx = np.arange(g * n, (g + 1) * n)
        beta[rng.choice(idx, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    jspec = J.GroupSpec.from_sizes(
        [n] * G, weights=rng.uniform(0.5, 2.0, G),
        feature_weights=rng.uniform(0.5, 2.0, G * n))
    kw = dict(F64, n_lambdas=12, min_ratio=0.05, safety=1e-6, min_bucket=16,
              screen=screen)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(J.Plan(**kw))
    sess = T.SGLSession(convert.problem(X, y, _children(jspec), device="cpu"))
    rt = sess.path(T.Plan(**kw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.1
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "n_pallas_screens", "buckets"):
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert rt.kept_features[1] < G * n
    base = sess.path(T.Plan(**dict(kw, screen="none")))
    np.testing.assert_allclose(rt.betas, base.betas, atol=5e-6)


@pytest.mark.parametrize("schedule,screen", [("lockstep", "tlfre"),
                                             ("lockstep", "gapsafe"),
                                             ("elastic", "gapsafe")])
def test_weighted_cv_matches_live_reference(schedule, screen):
    """Plan weights in ``.cv``: the fold engine's weighted margin ranking,
    weighted screens and prox; the grid anchored at the weighted
    ``lambda_max``."""
    rng = np.random.default_rng(7)
    N, G, n = 60, 30, 5
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    for g in rng.choice(G, 4, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    wr = np.random.default_rng(2)
    gw, fw = wr.uniform(0.5, 2.0, G), wr.uniform(0.5, 2.0, G * n)
    kw = dict(F64, n_folds=3, n_lambdas=10, min_bucket=32, screen=screen,
              schedule=schedule, group_weights=gw, feature_weights=fw)
    jspec = J.GroupSpec.uniform_groups(G, n)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).cv(J.Plan(**kw))
    rt = T.SGLSession(T.Problem.sgl(X, y, [n] * G, device="cpu")).cv(
        T.Plan(**kw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    assert abs(rt.lam_max - rj.lam_max) <= 1e-12 * rj.lam_max
    np.testing.assert_allclose(rt.fold_betas, rj.fold_betas, atol=1e-8)
    np.testing.assert_allclose(rt.mse_path, rj.mse_path, atol=1e-8)
    assert rt.best_index == rj.best_index and rt.index_1se == rj.index_1se
    if schedule == "lockstep":
        for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
                  "buckets"):
            assert getattr(rt.stats, f) == getattr(rj.stats, f), f
        np.testing.assert_array_equal(rt.stats.fold_sweeps,
                                      rj.stats.fold_sweeps)
        np.testing.assert_array_equal(rt.kept_features, rj.kept_features)


@pytest.mark.parametrize("weights", ["group", "group+feature"])
def test_kernel_route_under_weights(weights, monkeypatch):
    """Float32 with ``use_kernels=True`` on the CPU: group weights keep the
    kernel route (every screen and every FISTA step through it); feature
    weights keep the ``xtv`` certification and run the prox and the screen
    statistics plainly; the compile count is the reference's
    ``use_pallas=True`` count."""
    from repro_torch.kernels import ops
    calls = {"xtv": 0, "sgl_prox": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _name=name, _orig=orig):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(ops, name, counted)
    rng = np.random.default_rng(120)
    N, G, n = 60, 4, 5
    X = rng.standard_normal((N, G * n)).astype(np.float32)
    beta = np.zeros(G * n)
    beta[:2] = np.abs(rng.standard_normal(2))
    beta[n:n + 2] = np.abs(rng.standard_normal(2))
    y = (X @ beta + 0.01 * rng.standard_normal(N)).astype(np.float32)
    wr = np.random.default_rng(9)
    extra = dict(group_weights=wr.uniform(0.5, 2.0, G))
    if weights == "group+feature":
        extra["feature_weights"] = wr.uniform(0.5, 2.0, G * n)
    kw = dict(n_lambdas=8, min_ratio=0.05, tol=1e-6, safety=1e-4,
              max_iter=20000, min_bucket=16, **extra)
    jspec = J.GroupSpec.uniform_groups(G, n)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(
        J.Plan(**kw, use_pallas=True))
    rt = T.SGLSession(T.Problem.sgl(X, y, [n] * G, device="cpu")).path(
        T.Plan(**kw, use_kernels=True))
    assert rt.stats.n_screens > 0
    assert rt.stats.n_pallas_screens == rj.stats.n_pallas_screens == (
        rt.stats.n_screens if weights == "group" else 0)
    assert rt.stats.n_compilations == rj.stats.n_compilations
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-5)
    assert calls["xtv"] > 0     # one a row solved (accepted or rejected)
    if weights == "group":
        assert calls["sgl_prox"] == rt.stats.fista_iters > 0
    else:
        assert calls["sgl_prox"] == 0


def test_weight_validation():
    X, y, sizes = make_problem()
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    for kw, match in ((dict(group_weights=np.ones(3)), "shape"),
                      (dict(group_weights=-np.ones(15)), "positive"),
                      (dict(feature_weights=np.ones(7)), "shape"),
                      (dict(feature_weights=np.zeros(60)), "positive"),
                      (dict(feature_weights=np.ones(60), feature_shards=2),
                       "feature_shards")):
        with pytest.raises(ValueError, match=match):
            sess.path(T.Plan(n_lambdas=4, **kw))
    nn = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu"))
    with pytest.raises(ValueError, match="SGL-only"):
        nn.path(T.Plan(n_lambdas=4, group_weights=np.ones(15)))
    with pytest.raises(ValueError, match="SGL-only"):
        nn.cv(T.Plan(n_lambdas=4, feature_weights=np.ones(60)))
