"""The port's two model-selection examples, ``cv_model_selection`` and
``session_refinement`` (``repro_torch.examples``), against the reference's
library calls, made in the sequence and with the arguments of
``examples/cv_model_selection.py`` and ``examples/session_refinement.py``
at reduced sizes.  A file of its own beside ``tests/test_torch_examples.py``
(the other four examples), so that each stays near a minute on one worker:
the reference's runs here are mostly XLA compilation.

As there, each reference run sits inside ``jax.enable_x64(False)``, as the
scripts run, on float32 inputs, and the port asks for float32.  Bars: CV
fold betas, the sequential paths, ``SGLCV``'s coef and each served job's
coef within ``1e-5 * max|beta|`` (a job's coef against the largest coef of
the queue: one job's design is unrelated to its response and both refits
sit within rounding of 0); the folds, ``best_index``, the selected groups,
stability's selection probabilities, ``refine``'s index and
``new_compilations`` and the batches equal; ``lambda_1se``, the selected
and best lambdas within 1e-6 relative; ``refine``'s FISTA iterations
within 10% (``spectral_norm``'s power method starts from numpy in the port
and from ``jax.random`` in the reference).  The training folds hold at
least 5/3 as many rows as features, so both float32 solutions sit within
rounding of the optimum.
"""
import jax
import numpy as np
import pytest

import repro.core as J
from repro import api as japi
from repro.launch import sgl_serve as jserve
from repro_torch.examples import cv_model_selection, session_refinement
from test_torch_examples import F32, _close, _f32


# -- cv_model_selection ------------------------------------------------------

CV = dict(N=150, G=12, n=5, K=5, n_lambdas=8, n_subsamples=10,
          stab_lambdas=6)


def test_cv_model_selection_matches_reference(capsys):
    out = cv_model_selection.run(**CV, device="cpu")
    X, y, beta_true, true_groups = cv_model_selection.data(
        CV["N"], CV["G"], CV["n"])
    X, y = _f32(X, y)
    G, n, K = CV["G"], CV["n"], CV["K"]
    spec = J.GroupSpec.uniform_groups(G, n)
    kw = cv_model_selection.plan_kwargs(CV["n_lambdas"])
    with jax.enable_x64(False):
        cv = J.sgl_cv(X, y, spec, 1.0, n_folds=K, **kw)
        seq = [J.sgl_path(X[train], y[train], spec, 1.0, lambdas=cv.lambdas,
                          engine="batched", **kw).betas
               for train, _ in cv.folds]
        est = japi.SGLCV(alpha=1.0, groups=[n] * G, n_folds=K,
                         n_lambdas=CV["n_lambdas"], min_ratio=0.03, tol=1e-7,
                         max_iter=8000).fit(X, y)
        stab = J.stability_selection(X, y, spec, 1.0,
                                     n_subsamples=CV["n_subsamples"],
                                     n_lambdas=CV["stab_lambdas"], tol=1e-6,
                                     batch_size=10, seed=1)
    got = out["cv"]
    for (a, _), (b, _) in zip(got.folds, cv.folds):
        np.testing.assert_array_equal(a, b)
    _close(got.fold_betas, cv.fold_betas, F32)
    assert got.best_index == cv.best_index
    assert got.lambda_1se == pytest.approx(cv.lambda_1se, rel=1e-6)
    assert (got.stats.n_screens, got.stats.n_segments) == \
        (cv.stats.n_screens, cv.stats.n_segments)
    for a, b in zip(out["seq_betas"], seq):
        _close(a, b, F32)
    _close(out["est"].coef_, est.coef_, F32)
    gids = np.asarray(spec.group_ids)
    np.testing.assert_array_equal(
        out["sel_groups"], np.unique(gids[np.abs(est.coef_) > 1e-6]))
    assert out["hit"] == len(np.intersect1d(out["sel_groups"], true_groups))
    np.testing.assert_array_equal(out["stab"].selection_probs,
                                  np.asarray(stab.selection_probs))
    np.testing.assert_array_equal(out["stable"], stab.max_probs >= 0.75)
    cv_model_selection.report(out)
    text = capsys.readouterr().out
    assert "stacked screens" in text and "stable set" in text


# -- session_refinement ------------------------------------------------------

SR = dict(N=150, G=12, n=5, n_folds=3, n_lambdas=8, serve_lambdas=6)


def test_session_refinement_matches_reference(capsys):
    out = session_refinement.run(**SR, device="cpu")
    X, y, beta_true, rng = session_refinement.data(SR["N"], SR["G"], SR["n"])
    G, n, N = SR["G"], SR["n"], SR["N"]
    with jax.enable_x64(False):
        problem = J.Problem.sgl(*_f32(X, y),
                                groups=J.GroupSpec.uniform_groups(G, n))
        plan = J.Plan(alpha=1.0, n_lambdas=SR["n_lambdas"],
                      n_folds=SR["n_folds"], tol=3e-6, safety=1e-6,
                      max_iter=8000, check_every=50)
        session = J.SGLSession(problem, plan)
        coarse = session.cv()
        ref = session.refine(factor=10.0)
        cold = J.SGLSession(problem).cv(plan.with_(lambdas=ref.fine.lambdas))
        server = jserve.SGLServer(J.Plan(
            n_folds=SR["n_folds"], n_lambdas=SR["serve_lambdas"], tol=1e-6,
            safety=1e-6, max_iter=6000, check_every=50))
        for X_job in (X, X):
            yb = X_job @ beta_true + 0.5 * rng.standard_normal(N)
            server.submit(*_f32(X_job, yb), groups=[n] * G)
        server.submit(*_f32(rng.standard_normal((N, G * n)), y),
                      groups=[n] * G)
        results = server.drain()
    _close(out["coarse"].fold_betas, coarse.fold_betas, F32)
    assert out["coarse"].best_index == coarse.best_index
    got = out["refined"]
    np.testing.assert_allclose(got.fine.lambdas, ref.fine.lambdas,
                               rtol=1e-6)
    _close(got.fine.fold_betas, ref.fine.fold_betas, F32)
    assert (got.index, got.new_compilations) == \
        (ref.index, ref.new_compilations)
    assert got.lambda_ == pytest.approx(ref.lambda_, rel=1e-6)
    assert abs(got.total_iters - ref.total_iters) <= 0.1 * ref.total_iters
    _close(out["cold"].fold_betas, cold.fold_betas, F32)
    assert out["same_selection"] == (ref.lambda_ == cold.best_lambda)
    assert sorted(out["results"]) == sorted(results)
    # one scale for the queue: the third job's design is unrelated to its
    # response, its refit sits at lambda_max and both coefs within rounding
    # of 0
    scale = max(np.max(np.abs(r.coef)) for r in results.values())
    for jid, want in results.items():
        r = out["results"][jid]
        assert r.error is None and want.error is None
        assert r.batched_with == want.batched_with
        assert r.best_lambda == pytest.approx(want.best_lambda, rel=1e-6)
        _close(r.coef, want.coef, F32, scale)
    session_refinement.report(out)
    assert "batched_with=[0, 1]" in capsys.readouterr().out
