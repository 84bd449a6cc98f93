"""The port's serving front end, ``repro_torch.launch.sgl_serve``, against
the live JAX reference's ``repro.launch.sgl_serve``.

Bars (float64): each job's ``coef`` and ``mean_mse`` within 1e-8 of the
reference server's on the same queue, ``best_lambda`` and ``n_iter``
equal, the batches the same.  The refit is a solo ``solve_sgl`` /
``solve_nn_lasso`` with ``check_every=10`` in both packages; for the
comparison both servers take the exact ``||X||_2`` (from the SVD) as the
refit's step bound.  Their own 50-step power methods start from different
vectors (``jax.random`` against numpy), and on this queue's second design
the port's stops 9.2% below ``||X||_2^2`` while the reference's reaches it
(181.73 against 200.22), which moves the refit by a gap check.  The
comparison's designs have as many training rows as features: with fewer,
the two packages' CV curves differ by up to 5e-6 at the grid's small
lambdas, as the reference's own screened and unscreened runs do (ROADMAP
queue 3).  ``tests/test_session.py``'s serving cases are replayed on the
port.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.launch import sgl_serve as jserve
from repro_torch.launch import sgl_serve as tserve

CMP_PLAN = dict(n_folds=3, n_lambdas=8, tol=1e-12, max_iter=100_000,
                min_bucket=32)


def _queue(rng, N=60, G=10, n=4):
    """Two jobs on one design, one on another, and a nonnegative-Lasso
    job."""
    p = G * n
    X1 = rng.standard_normal((N, p))
    X2 = rng.standard_normal((N, p))
    jobs = []
    for X in (X1, X1, X2):
        b = np.zeros(p)
        b[rng.choice(p, 5, replace=False)] = rng.standard_normal(5)
        jobs.append((X, X @ b + 0.3 * rng.standard_normal(N), "sgl"))
    b = np.zeros(p)
    b[:4] = np.abs(rng.standard_normal(4)) + 0.5
    jobs.append((X2, X2 @ b + 0.3 * rng.standard_normal(N), "nn_lasso"))
    return jobs, [n] * G


def _exact_norm(X):
    """``||X||_2`` from the SVD, in X's package and dtype."""
    top = float(np.linalg.svd(np.asarray(X), compute_uv=False)[0])
    if isinstance(X, torch.Tensor):
        return torch.tensor(top, dtype=X.dtype)
    return type(X)(top) if np.isscalar(X) else np.asarray(top, X.dtype)


@pytest.fixture(scope="module")
def served():
    jobs, sizes = _queue(np.random.default_rng(3))
    sj = jserve.SGLServer(J.Plan(**CMP_PLAN))
    st = tserve.SGLServer(T.Plan(**CMP_PLAN), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "spectral_norm", _exact_norm)
        mp.setattr(tserve, "spectral_norm", _exact_norm)
        for server in (sj, st):
            for X, y, penalty in jobs:
                server.submit(X, y, penalty=penalty,
                              groups=sizes if penalty == "sgl" else None)
        return jobs, sizes, sj.drain(), st.drain(), st


def test_server_matches_reference(served):
    jobs, _, rj, rt, _ = served
    assert sorted(rt) == sorted(rj) == list(range(len(jobs)))
    for jid in rj:
        a, b = rt[jid], rj[jid]
        assert a.error is None and b.error is None
        assert a.batched_with == b.batched_with
        np.testing.assert_allclose(a.lambdas, b.lambdas, rtol=1e-12)
        np.testing.assert_allclose(a.mean_mse, b.mean_mse, atol=1e-8)
        np.testing.assert_allclose(a.se_mse, b.se_mse, atol=1e-8)
        assert a.best_lambda == pytest.approx(b.best_lambda, rel=1e-12)
        assert a.lambda_1se == pytest.approx(b.lambda_1se, rel=1e-12)
        np.testing.assert_allclose(a.coef, np.asarray(b.coef), atol=1e-8)
        assert np.abs(a.coef).max() > 0.1
        assert a.n_iter == b.n_iter
        assert a.new_compilations == b.new_compilations
    assert rt[0].batched_with == [0, 1]
    assert rt[3].coef.min() >= 0.0


def test_refit_is_a_solo_solve(served):
    """Each job's refit equals a solo ``solve_sgl`` / ``solve_nn_lasso``
    with ``check_every=10`` at its selected lambda, bit for bit."""
    jobs, sizes, _, rt, _ = served
    for jid, (X, y, penalty) in enumerate(jobs):
        Xd, yd = torch.as_tensor(X), torch.as_tensor(y)
        L = _exact_norm(Xd) ** 2
        lam = rt[jid].best_lambda
        if penalty == "sgl":
            spec = T.GroupSpec.from_sizes(sizes, device="cpu")
            fit = T.solve_sgl(Xd, yd, spec, lam, 1.0, L, check_every=10,
                              tol=CMP_PLAN["tol"],
                              max_iter=CMP_PLAN["max_iter"])
        else:
            fit = T.solve_nn_lasso(Xd, yd, lam, L, check_every=10,
                                   tol=CMP_PLAN["tol"],
                                   max_iter=CMP_PLAN["max_iter"])
        np.testing.assert_array_equal(rt[jid].coef, fit.beta.numpy())
        assert rt[jid].n_iter == fit.iters


def test_server_aggregates_and_warm_resubmission(served, monkeypatch):
    jobs, sizes, _, rt, st = served
    assert st.stats.n_compilations == sum(
        {r.batched_with[0]: r.new_compilations for r in rt.values()}
        .values()) > 0
    monkeypatch.setattr(tserve, "spectral_norm", _exact_norm)
    for X, y, penalty in jobs:
        st.submit(X, y, groups=sizes if penalty == "sgl" else None,
                  penalty=penalty)
    warm = st.drain()
    assert all(r.new_compilations == 0 for r in warm.values())
    for jid in range(len(jobs)):
        np.testing.assert_array_equal(warm[jid + len(jobs)].coef,
                                      rt[jid].coef)


def test_batch_lambda_max_is_each_jobs_anchor():
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((30, 24)))
    ys = torch.as_tensor(rng.standard_normal((3, 30)))
    spec = T.GroupSpec.from_sizes([4] * 6, device="cpu")
    got = tserve._batch_lambda_max(X, ys, spec, 0.7, penalty="sgl")
    for t in range(3):
        assert float(got[t]) == pytest.approx(
            float(T.lambda_max_sgl(spec, X.T @ ys[t], 0.7)[0]), rel=1e-14)
    got = tserve._batch_lambda_max(X, ys, None, 1.0, penalty="nn_lasso")
    np.testing.assert_allclose(got.numpy(), (ys @ X).max(dim=1).values,
                               rtol=1e-14)
    want = jserve._batch_lambda_max(np.asarray(X), np.asarray(ys),
                                    J.GroupSpec.from_sizes([4] * 6), 0.7,
                                    penalty="sgl")
    np.testing.assert_allclose(
        tserve._batch_lambda_max(X, ys, spec, 0.7, penalty="sgl").numpy(),
        np.asarray(want), rtol=1e-12)


# ---------------------------------------------------------------------------
# tests/test_session.py's serving cases, replayed on the port
# ---------------------------------------------------------------------------

def test_sgl_serve_fold_stacked_batches_match_independent_cv():
    """``tests/test_session.py:315``."""
    rng = np.random.default_rng(0)
    N, G, n = 48, 12, 4
    p = G * n
    plan = T.Plan(n_folds=3, n_lambdas=8, tol=1e-10, max_iter=100_000,
                  min_bucket=32)
    server = tserve.SGLServer(plan, device="cpu")
    X1 = rng.standard_normal((N, p))
    X2 = rng.standard_normal((N, p))
    jobs = []
    for X in (X1, X1, X2):
        b = np.zeros(p)
        b[rng.choice(p, 5, replace=False)] = rng.standard_normal(5)
        y = X @ b + 0.01 * rng.standard_normal(N)
        jobs.append((X, y))
        server.submit(X, y, groups=[n] * G)
    assert server.pending == 3
    results = server.drain()
    assert server.pending == 0 and len(results) == 3
    assert results[0].batched_with == [0, 1]
    assert results[2].batched_with == [2]
    for jid, (X, y) in enumerate(jobs):
        r = results[jid]
        ref = T.sgl_cv(X, y, [n] * G, 1.0, n_folds=3, lambdas=r.lambdas,
                       tol=1e-10, max_iter=100_000, min_bucket=32,
                       device="cpu")
        np.testing.assert_allclose(r.mean_mse, ref.mean_mse, atol=1e-8)
        assert r.best_lambda == ref.best_lambda
        assert r.coef.shape == (p,)
        assert np.isfinite(r.latency) and r.latency > 0
    for X, y in jobs:
        server.submit(X, y, groups=[n] * G)
    warm = server.drain()
    assert all(r.new_compilations == 0 for r in warm.values())
    for jid in range(3):
        np.testing.assert_array_equal(warm[jid + 3].coef, results[jid].coef)


def test_sgl_serve_validates_plan_and_distinguishes_specs():
    """``tests/test_session.py:355``."""
    with pytest.raises(ValueError):
        tserve.SGLServer(T.Plan(selection="mim"), device="cpu").submit(
            np.zeros((4, 2)), np.zeros(4))
    with pytest.raises(ValueError):
        tserve.SGLServer(T.Plan(center="per-fold"), device="cpu").submit(
            np.zeros((4, 2)), np.zeros(4), penalty="nn_lasso")
    with pytest.raises(ValueError):
        tserve.SGLServer(device="cpu").submit(np.zeros((4, 2)), np.zeros(4),
                                              penalty="ridge")
    c = [1] * 64 + [2, 1] + [1] * 62
    d = [1] * 64 + [1, 2] + [1] * 62

    def spec(sizes):
        return T.GroupSpec.from_sizes(sizes, device="cpu")
    assert tserve._spec_key(spec(c)) != tserve._spec_key(spec(d))
    assert tserve._spec_key(spec(c)) == tserve._spec_key(spec(list(c)))
    X = np.random.default_rng(0).standard_normal((5, 3))
    assert tserve._fingerprint(X) == jserve._fingerprint(X)


def test_sgl_serve_isolates_failing_batches_and_honors_folds():
    """``tests/test_session.py:376``."""
    rng = np.random.default_rng(1)
    N, p = 40, 60
    folds = T.kfold_indices(N, 3, seed=7)
    server = tserve.SGLServer(T.Plan(folds=folds, n_lambdas=6, tol=1e-9,
                                     max_iter=50_000, min_bucket=32),
                              device="cpu")
    X = rng.standard_normal((N, p))
    b = np.zeros(p)
    b[:4] = np.abs(rng.standard_normal(4)) + 0.5
    y = X @ b + 0.01 * rng.standard_normal(N)
    good = server.submit(X, y, groups=[4] * (p // 4))
    degen = server.submit(-np.abs(rng.standard_normal((N, p))) - 0.1,
                          np.abs(y) + 0.1, penalty="nn_lasso")
    boom = server.submit(rng.standard_normal((N, p)), y,
                         penalty="nn_lasso")
    boom_fp = server._queue[-1].fingerprint
    orig_run = server._run_batch

    def run_batch(jobs):
        if jobs[0].fingerprint == boom_fp:
            raise RuntimeError("forced batch failure")
        return orig_run(jobs)

    server._run_batch = run_batch
    results = server.drain()
    assert results[degen].error is None
    np.testing.assert_array_equal(results[degen].coef, 0.0)
    assert results[boom].error == "forced batch failure"
    assert results[boom].batched_with == [boom]
    assert results[good].error is None
    assert np.isfinite(results[good].best_lambda)
    ref = T.sgl_cv(X, y, [4] * (p // 4), 1.0, folds=folds,
                   lambdas=results[good].lambdas, tol=1e-9,
                   max_iter=50_000, min_bucket=32, device="cpu")
    np.testing.assert_allclose(results[good].mean_mse, ref.mean_mse,
                               atol=1e-8)


def test_sgl_serve_smoke_cli(capsys):
    """``tests/test_session.py:433``, at its sizes, on the CPU."""
    res = tserve.main(["--smoke", "--designs", "1", "--jobs-per-design",
                       "2", "--rows", "40", "--groups", "8", "--group-size",
                       "4", "--folds", "2", "--lambdas", "6", "--device",
                       "cpu"])
    assert len(res) == 2
    for r in res.values():
        assert r.error is None
        assert np.isfinite(r.best_lambda) and r.latency > 0
        assert r.coef.dtype == np.float32       # the CLI's default dtype
    out = capsys.readouterr().out
    assert "0 sweep compilations" in out and "cpu, float32" in out


def test_server_dtype_and_default_device(monkeypatch):
    """``dtype=None`` keeps each job's input dtype; float32 and float64
    jobs of one design run in separate batches.  ``device=None`` means the
    card and raises without one."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((30, 16))
    y = X[:, 0] + 0.1 * rng.standard_normal(30)
    server = tserve.SGLServer(T.Plan(n_folds=2, n_lambdas=4, tol=1e-6),
                              device="cpu")
    a = server.submit(X, y, groups=[4] * 4)
    b = server.submit(X.astype(np.float32), y.astype(np.float32),
                      groups=[4] * 4)
    res = server.drain()
    assert res[a].batched_with == [a] and res[b].batched_with == [b]
    assert res[a].coef.dtype == np.float64
    assert res[b].coef.dtype == np.float32
    np.testing.assert_allclose(res[b].coef, res[a].coef, atol=1e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.SGLServer()
