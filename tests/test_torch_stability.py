"""The port's stability selection, ``SGLSession.stability`` and the
``stability_selection`` shim, against the live JAX reference.

Bars: ``subsample_masks`` equal to the reference's, row for row;
``selection_probs`` equal on the default (TLFre) screen, float64; the
engine counters equal under the lockstep schedule.  Half-row subsamples
have fewer rows than features, and off the screen the reference's own
betas move by about 1e-7 (ROADMAP queue 3), which can flip the
``active_tol = 1e-8`` test; with the screen on they agree far inside it.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core import cv as jcv
from repro_torch.core import cv as tcv


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


def signal_problem():
    """``tests/test_cv.py:test_stability_selection_separates_signal_from_
    null``'s data: group 0 carries the signal."""
    rng = np.random.default_rng(1)
    G, n, N = 20, 5, 40
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    beta[:4] = 2.0
    y = X @ beta + 0.05 * rng.standard_normal(N)
    return X, y, [n] * G


# tests/test_session.py:106's plan
PLAN = dict(n_subsamples=6, batch_size=3, n_lambdas=6, min_ratio=0.05,
            tol=1e-7, specnorm_method="fro")


@pytest.mark.parametrize("N,B,frac,seed", [(40, 6, 0.5, 0), (40, 8, 0.5, 1),
                                           (57, 5, 0.3, 3), (250, 50, 0.5, 0),
                                           (7, 3, 0.01, 2)])
def test_subsample_masks_equal_the_reference(N, B, frac, seed):
    mt = tcv.subsample_masks(N, B, frac, seed)
    np.testing.assert_array_equal(mt, jcv.subsample_masks(N, B, frac, seed))
    assert mt.shape == (B, N)
    np.testing.assert_array_equal(mt.sum(axis=1),
                                  max(1, int(round(frac * N))))


def _sessions(X, y, sizes):
    return (J.SGLSession(J.Problem.sgl(X, y, J.GroupSpec.from_sizes(sizes))),
            T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")))


@pytest.mark.parametrize("schedule", ["lockstep", "elastic"])
def test_selection_probs_and_counters_match_reference(schedule):
    X, y, sizes = sgl_problem(seed=1, N=40, G=16, n=4)
    sj, st = _sessions(X, y, sizes)
    rj = sj.stability(J.Plan(**PLAN, schedule=schedule))
    rt = st.stability(T.Plan(**PLAN, schedule=schedule))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_array_equal(rt.selection_probs, rj.selection_probs)
    np.testing.assert_array_equal(rt.max_probs, rj.max_probs)
    assert 0 < rt.selection_probs.max() <= 1.0
    assert rt.n_subsamples == rj.n_subsamples == PLAN["n_subsamples"]
    fields = ["n_compilations", "n_rejected", "n_pallas_screens"]
    if schedule == "lockstep":
        fields += ["n_segments", "n_screens"]
    for f in fields:
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f
    assert rt.stats.buckets == rj.stats.buckets == []   # merged without
    # the session aggregates the run
    assert st.stats.n_compilations == rt.stats.n_compilations > 0


def test_stability_with_adaptive_group_weights_matches_reference():
    """The plan's adaptive group weights reach every batch (the effective
    spec), as in the reference."""
    X, y, sizes = sgl_problem(seed=1, N=40, G=16, n=4)
    gw = np.random.default_rng(3).uniform(0.5, 2.0, 16)
    sj, st = _sessions(X, y, sizes)
    rj = sj.stability(J.Plan(**PLAN, group_weights=gw))
    rt = st.stability(T.Plan(**PLAN, group_weights=gw))
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    np.testing.assert_array_equal(rt.selection_probs, rj.selection_probs)


def test_stability_refuses_the_nonnegative_lasso():
    X, y, _ = sgl_problem(seed=1, N=40, G=16, n=4)
    sess = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu"))
    with pytest.raises(ValueError, match="SGL penalty"):
        sess.stability(T.Plan(**PLAN))


# ---------------------------------------------------------------------------
# tests/test_session.py and tests/test_cv.py's stability cases, on the port
# ---------------------------------------------------------------------------

def test_session_stability_reuses_buckets():
    """``tests/test_session.py:106``."""
    X, y, sizes = sgl_problem(seed=1, N=40, G=16, n=4)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    s1 = sess.stability(T.Plan(**PLAN))
    s2 = sess.stability(T.Plan(**PLAN))
    assert s1.selection_probs.shape == s2.selection_probs.shape
    assert s2.stats.n_compilations == 0
    np.testing.assert_array_equal(s1.selection_probs, s2.selection_probs)


def test_stability_shim_matches():
    """``tests/test_session.py:170``: the shim equals the session verb, and
    warns once as a legacy entry point."""
    X, y, sizes = sgl_problem(seed=1, N=40, G=16, n=4)
    kw = dict(n_subsamples=4, n_lambdas=5, min_ratio=0.05, tol=1e-7,
              batch_size=2, seed=1)
    with pytest.warns(DeprecationWarning, match="SGLSession.stability"):
        T.problem._WARNED.discard("stability_selection")
        legacy = T.stability_selection(X, y, sizes, 1.0, device="cpu", **kw)
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    new = sess.stability(T.Plan(**kw, specnorm_method="fro"))
    np.testing.assert_array_equal(legacy.selection_probs,
                                  new.selection_probs)
    ref = J.stability_selection(X, y, J.GroupSpec.from_sizes(sizes), 1.0,
                                **kw)
    np.testing.assert_array_equal(legacy.selection_probs,
                                  ref.selection_probs)


def test_stability_selection_separates_signal_from_null():
    """``tests/test_cv.py:253``, and the reference's probabilities."""
    X, y, sizes = signal_problem()
    G, n = len(sizes), sizes[0]
    kw = dict(n_subsamples=8, n_lambdas=6, tol=1e-7, batch_size=4, seed=1)
    st = T.stability_selection(X, y, sizes, 1.0, device="cpu", **kw)
    assert st.selection_probs.shape == (6, G * n)
    assert np.all(st.selection_probs >= 0) and np.all(
        st.selection_probs <= 1)
    assert st.max_probs[:4].min() >= 0.9     # true features always selected
    assert st.max_probs[n:].mean() < 0.5     # null features mostly not
    ref = J.stability_selection(X, y, J.GroupSpec.from_sizes(sizes), 1.0,
                                **kw)
    np.testing.assert_array_equal(st.selection_probs, ref.selection_probs)


def test_stability_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(T.groups.torch.cuda, "is_available", lambda: False)
    X, y, sizes = sgl_problem(seed=1, N=40, G=16, n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.stability_selection(X, y, sizes, 1.0, n_subsamples=2)
