"""Sparse-group logistic regression in the port,
``SGLSession(Problem.sgl_logistic(X, y01, groups)).path(...)``, against
the live JAX reference.

Tolerances:

* The loss's methods: rtol 1e-12 in float64 (``effective_tol`` exactly).
* float64 paths at ``tol=1e-13``: betas within 1e-8; segments, screens,
  compilations, rejections, buckets and kept sets equal.
* Every accepted row carries a full-problem duality-gap certificate, gap <=
  2 * tol * gap_scale, recomputed from scratch
  (``tests/test_loss_generic.py``'s bar); the Gap-Safe screened path
  reproduces the unscreened one within 5e-6 (the same file's bar).
* Refusals as in the reference: CV (the masked-row embedding), the TLFre
  screen, labels outside {0, 1}.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T


def logistic_problem(seed=0, N=60, G=10, n=4):
    """``tests/test_loss_generic.py:_logistic_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 3, replace=False):
        beta[g * n:g * n + 2] = rng.standard_normal(2)
    y = (X @ beta + 0.5 * rng.standard_normal(N) > 0).astype(float)
    return X, y, [n] * G


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_logistic_loss_matches_reference():
    rng = np.random.default_rng(1)
    N = 25
    y = (rng.random(N) > 0.4).astype(float)
    u = rng.standard_normal(N) * 3
    u[0], u[1] = 40.0, -40.0                     # the stable branches
    theta = 0.1 * (y - 0.5)
    jl, tl = J.LOGISTIC, T.LOGISTIC
    assert (tl.name, tl.gamma, tl.supports_masked_rows) == \
        (jl.name, jl.gamma, jl.supports_masked_rows) == ("logistic", 0.25,
                                                         False)
    assert T.get_loss("logistic") is tl and T.get_loss(tl) is tl
    assert T.SQUARED.supports_masked_rows and T.SQUARED.gamma == 1.0
    yj, uj, yt, ut = jnp.asarray(y), jnp.asarray(u), _t(y), _t(u)
    for name in ("grad", "residual"):
        np.testing.assert_allclose(getattr(tl, name)(yt, ut).numpy(),
                                   np.asarray(getattr(jl, name)(yj, uj)),
                                   rtol=1e-12)
    np.testing.assert_allclose(tl.residual_at_zero(yt).numpy(), y - 0.5)
    r = tl.residual(yt, ut)
    np.testing.assert_allclose(
        float(tl.primal_value(yt, ut, r)),
        float(jl.primal_value(yj, uj, jnp.asarray(r.numpy()))), rtol=1e-12)
    for lam in (0.5, 2.0):
        np.testing.assert_allclose(
            float(tl.dual_value(yt, _t(theta), lam)),
            float(jl.dual_value(yj, jnp.asarray(theta), lam)), rtol=1e-12)
    lams = np.asarray([0.5, 2.0])
    np.testing.assert_allclose(
        tl.dual_value(yt, _t(theta), _t(lams)[:, None]).numpy(),
        [float(jl.dual_value(yj, jnp.asarray(theta), lam)) for lam in lams],
        rtol=1e-12)
    assert tl.gap_scale_host(yt) == jl.gap_scale_host(yj)
    assert float(tl.gap_scale(yt)) == float(jl.gap_scale(yj))
    assert tl.effective_tol(1e-12, torch.float32) == \
        64.0 * float(np.finfo(np.float32).eps)
    assert tl.effective_tol(1e-6, torch.float64) == 1e-6
    with pytest.raises(ValueError, match="unknown loss"):
        T.get_loss("hinge")


@pytest.mark.parametrize("screen", ["gapsafe", "none"])
def test_logistic_path_f64_matches_live_reference(screen):
    X, y, sizes = logistic_problem(4)
    kw = dict(alpha=0.9, n_lambdas=10, min_ratio=0.1, tol=1e-13,
              max_iter=200_000, screen=screen)
    rj = J.SGLSession(J.Problem.sgl_logistic(
        X, y, J.GroupSpec.from_sizes(sizes))).path(J.Plan(**kw))
    sess = T.SGLSession(T.Problem.sgl_logistic(X, y, sizes, device="cpu"))
    rt = sess.path(T.Plan(**kw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    assert abs(rt.lam_max - rj.lam_max) <= 1e-12 * rj.lam_max
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.1
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "n_pallas_screens", "buckets"):
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    assert (rt.stats.n_screens > 0) == (screen == "gapsafe")
    assert sess.path(T.Plan(**kw)).stats.n_compilations == 0


def test_logistic_path_certifies_every_grid_point():
    """Every accepted row's full-problem duality gap, recomputed from the
    port's loss and Lemma-9 scaling, is within 2 * tol * gap_scale."""
    X, y, sizes = logistic_problem(3)
    tol = 1e-8
    sess = T.SGLSession(T.Problem.sgl_logistic(X, y, sizes, device="cpu"))
    res = sess.path(T.Plan(alpha=0.9, n_lambdas=10, min_ratio=0.1, tol=tol,
                           max_iter=50_000))
    spec, L = sess.problem.spec, T.LOGISTIC
    Xt, yt = _t(X), _t(y)
    scale = L.gap_scale_host(yt)
    for j, lam in enumerate(res.lambdas):
        beta = _t(res.betas[j])
        fit = Xt @ beta
        resid = L.residual(yt, fit)
        s = T.dual_scaling_sgl(spec, Xt.T @ (resid / lam), 0.9)
        theta = s * resid / lam
        pval = (float(L.primal_value(yt, fit, resid))
                + lam * float(T.sgl_penalty(spec, beta, 0.9)))
        dval = float(L.dual_value(yt, theta, lam))
        assert pval - dval <= 2.0 * tol * scale


def test_logistic_screened_equals_unscreened():
    X, y, sizes = logistic_problem(4)
    kw = dict(alpha=1.0, n_lambdas=10, min_ratio=0.1, tol=1e-10,
              max_iter=50_000)
    sess = T.SGLSession(T.Problem.sgl_logistic(X, y, sizes, device="cpu"))
    res_s = sess.path(T.Plan(screen="gapsafe", **kw))
    res_b = sess.path(T.Plan(screen="none", **kw))
    np.testing.assert_allclose(res_s.betas, res_b.betas, atol=5e-6)
    assert sess.path(T.Plan(**kw)).stats.n_screens == res_s.stats.n_screens


def test_f32_logistic_path_keeps_certificates(monkeypatch):
    """The float32 floor of the gap tolerance lives in the loss: an
    unreachable tol certifies at the floor instead of running every solve
    to max_iter.  The float32 logistic path takes the kernel route (plain
    versions on the CPU): the prox does not depend on the loss, so FISTA
    steps through ``sgl_prox``; every Gap-Safe screen's group statistics
    go through ``screen_norms_gather`` on the (1, p) center row."""
    from repro_torch.kernels import ops
    calls = {"sgl_prox": 0, "screen_norms_gather": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _name=name, _orig=orig):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(ops, name, counted)
    X, y, sizes = logistic_problem(7)
    max_iter = 5000
    res = T.SGLSession(T.Problem.sgl_logistic(
        X.astype(np.float32), y.astype(np.float32), sizes,
        device="cpu")).path(T.Plan(n_lambdas=8, min_ratio=0.15, tol=1e-12,
                                   max_iter=max_iter, use_kernels=True))
    assert np.all(res.iters < max_iter)
    assert res.stats.n_pallas_screens == res.stats.n_screens > 0
    assert calls["screen_norms_gather"] == res.stats.n_screens
    assert calls["sgl_prox"] == res.stats.fista_iters > 0


def test_logistic_refusals():
    X, y, sizes = logistic_problem(5)
    sess = T.SGLSession(T.Problem.sgl_logistic(X, y, sizes, device="cpu"))
    assert sess.problem.loss == "logistic"
    assert T.Plan().resolved_screen("sgl", "logistic") == "gapsafe"
    with pytest.raises(NotImplementedError, match="masked"):
        sess.cv(T.Plan(n_lambdas=5, min_ratio=0.2, n_folds=3))
    with pytest.raises(ValueError, match="tlfre"):
        sess.path(T.Plan(n_lambdas=5, screen="tlfre"))
    with pytest.raises(ValueError, match="tlfre"):
        T.sgl_path_batched(sess.problem.X, sess.problem.y, sess.problem.spec,
                           1.0, n_lambdas=5, screen="tlfre",
                           loss="logistic")
    with pytest.raises(ValueError, match="labels"):
        T.Problem.sgl_logistic(X, y + 0.5, sizes, device="cpu")
    with pytest.raises(ValueError, match="squared"):
        T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")).path(
            T.Plan(n_lambdas=4, loss="logistic"))
    with pytest.raises(ValueError, match="unknown loss"):
        sess.path(T.Plan(n_lambdas=4, loss="hinge"))


def test_logistic_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, sizes = logistic_problem(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Problem.sgl_logistic(X, y, sizes)
