"""The port's main path, ``SGLSession(Problem.sgl(...)).path(Plan())``,
against the live JAX reference on the same numpy problems.

Tolerances:

* float64 at ``tol=1e-13``: lambda grids 1e-12 relative, betas 1e-8 (the
  engine-parity bar of ``tests/test_path_engine.py``).  The path's
  structure agrees exactly: segments, screens, compilations, rejections,
  buckets, kept sets.  FISTA iteration counts of single rows may differ by
  a few gap checks: the Lipschitz estimates differ in their last digits
  (the port seeds the power method from numpy, not ``jax.random``), and at
  this tolerance the gap test reads values at float64 rounding, so the
  test holds the total iteration count to within 10%.
* float32 through the kernels: ``tests/test_torch_kernels.py``.
* The committed golden capture (``tests/data/golden_squared.npz``, written
  by an older jax): betas 1e-8, never bit for bit.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import convert

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


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


def ragged_problem(seed=5, N=50, G=30):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 8, size=G)]
    p = sum(sizes)
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 8, replace=False)] = rng.standard_normal(8)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, sizes


def _run_both(X, y, sizes, plan_kw):
    jspec = J.GroupSpec.from_sizes(sizes)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(J.Plan(**plan_kw))
    sess = T.SGLSession(convert.problem(X, y, _children(jspec), device="cpu"))
    rt = sess.path(T.Plan(**plan_kw))
    return rj, rt, sess


def _assert_counters_equal(rj, rt):
    """The engine's counters, where there are any (the legacy driver
    reports none, on both sides), then iterations and kept sets."""
    sj, st = rj.stats, rt.stats
    assert (sj is None) == (st is None)
    for f in ("n_segments", "n_screens", "n_compilations", "n_rejected",
              "n_pallas_screens", "buckets"):
        if sj is not None:
            assert getattr(st, f) == getattr(sj, f), f
    assert abs(int(rt.iters.sum()) - int(rj.iters.sum())) <= \
        0.1 * int(rj.iters.sum())
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    np.testing.assert_array_equal(rt.kept_groups, rj.kept_groups)


F64_CASES = {
    "golden-shape": (make_problem, dict(alpha=0.9, n_lambdas=20,
                                        min_ratio=0.05)),
    "engine-tlfre": (sgl_problem, dict(n_lambdas=16, min_bucket=32)),
    "engine-none": (sgl_problem, dict(n_lambdas=16, min_bucket=32,
                                      screen="none")),
    "ragged-frobenius": (ragged_problem, dict(n_lambdas=12, min_bucket=16,
                                              specnorm_method="frobenius")),
}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_path_f64_matches_live_reference(case):
    make, kw = F64_CASES[case]
    kw = dict(kw, tol=1e-13, max_iter=200_000)
    X, y, sizes = make()
    rj, rt, sess = _run_both(X, y, sizes, kw)
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    assert abs(rt.lam_max - rj.lam_max) <= 1e-12 * rj.lam_max
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.1
    _assert_counters_equal(rj, rt)
    assert rt.stats.n_pallas_screens == 0       # float64 never engages them
    # a warm second call over the same buckets pays no new compilation
    warm = sess.path(T.Plan(**kw))
    assert warm.stats.n_compilations == 0
    np.testing.assert_array_equal(warm.betas, rt.betas)


def test_path_matches_golden_capture_within_tolerance():
    golden = np.load(DATA / "golden_squared.npz")
    X, y, sizes = make_problem()
    plan = T.Plan(alpha=0.9, n_lambdas=20, min_ratio=0.05, tol=1e-9,
                  max_iter=20000)
    res = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")).path(plan)
    np.testing.assert_allclose(res.lambdas, golden["path_lambdas"],
                               rtol=1e-12)
    np.testing.assert_allclose(res.betas, golden["path_betas"], atol=1e-8)


def test_kernel_route_counts_launches_only_on_the_card():
    """On the CPU the kernel route runs the plain versions: the path is
    the kernel route's (n_pallas_screens counts it), the launch counters
    stay at zero."""
    from repro_torch.kernels import ops
    X, y, sizes = make_problem()
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.sgl(X, y, sizes, dtype=torch.float32,
                                     device="cpu")).path(
        T.Plan(n_lambdas=6, tol=1e-6, safety=1e-6, use_kernels=True))
    assert res.stats.n_pallas_screens == res.stats.n_screens > 0
    assert sum(ops.launch_counts().values()) == 0
    assert np.isfinite(res.betas).all()


def test_cpu_kernel_route_captures_no_graph():
    """On the CPU the float32 kernel route runs the eager FISTA loop
    through the plain prox: the session's graph cache stays empty, and
    ``n_compilations`` is the reference's ``use_pallas=True`` count, cold
    and warm."""
    X, y, sizes = make_problem()
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16)
    jspec = J.GroupSpec.from_sizes(sizes)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(
        J.Plan(**kw, use_pallas=True))
    sess = T.SGLSession(convert.problem(X, y, _children(jspec),
                                        device="cpu"))
    plan = T.Plan(**kw, use_kernels=True)
    rt = sess.path(plan)
    assert rt.stats.n_compilations == rj.stats.n_compilations > 0
    assert sess.path(plan).stats.n_compilations == 0
    assert not sess.fista_graphs


def test_engine_counts_fista_iterations_run():
    """``stats.fista_iters`` counts every FISTA iteration the sweeps ran,
    rejected rows' included, so it bounds the accepted rows' iterations;
    the session accumulates it."""
    X, y, sizes = make_problem()
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16)
    res = sess.path(plan)
    assert res.stats.fista_iters >= int(res.iters.sum()) > 0
    assert sess.stats.fista_iters == res.stats.fista_iters
    if res.stats.n_rejected == 0:
        assert res.stats.fista_iters == int(res.iters.sum())


def test_replay_counts_the_launches_its_capture_recorded():
    """A wrapper called under stream capture counts a recorded call, not
    a launch; each replay adds the recorded calls to the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sgl_prox as kprox
    ops.reset_launch_counts()
    before = ops.captured_counts()
    kprox.captured += 3                 # what a capture of 3 calls leaves
    try:
        after = ops.captured_counts()
        recorded = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        assert recorded == {"sgl_prox": 3}
        assert sum(ops.launch_counts().values()) == 0
        for _ in range(2):
            ops.count_replay(recorded)
        assert ops.launch_counts()["sgl_prox"] == 6
        assert sum(ops.launch_counts().values()) == 6
    finally:
        kprox.captured -= 3
        ops.reset_launch_counts()


def test_graphed_fista_refuses_the_cpu():
    X, y, sizes = make_problem()
    spec = T.GroupSpec.from_sizes(sizes, device="cpu")
    X32 = torch.as_tensor(X, dtype=torch.float32)
    with pytest.raises(ValueError, match="card"):
        T.fista_sgl_graphed(X32, torch.as_tensor(y, dtype=torch.float32),
                            spec, 0.5, 1.0, 100.0, torch.zeros(X.shape[1]),
                            graphs={})


def test_float64_with_kernels_requested_raises():
    X, y, sizes = make_problem()
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))
    assert sess.problem.dtype == torch.float64
    with pytest.raises(TypeError):
        sess.path(T.Plan(n_lambdas=4, use_kernels=True))
    with pytest.raises(TypeError):
        T.sgl_path_batched(sess.problem.X, sess.problem.y, sess.problem.spec,
                           1.0, n_lambdas=4, use_kernels=True)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, sizes = make_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Problem.sgl(X, y, sizes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.GroupSpec.from_sizes(sizes)


@pytest.mark.parametrize("field,value", [
    ("engine", "legacy"),
    ("screen", "gapsafe"),
    ("loss", "logistic"),
    ("feature_weights", np.linspace(0.5, 2.0, 60)),
    ("group_weights", np.linspace(0.5, 2.0, 15)),
    ("feature_shards", 3),
])
def test_ported_plan_values_match_live_reference(field, value):
    """The plan values this port once refused now run, and match the
    reference: float64 at tol 1e-13, betas within 1e-8 and the engine's
    counters equal.  ``loss='logistic'`` runs on 0/1 labels."""
    X, y, sizes = make_problem()
    if field == "loss":
        y = (y > 0).astype(float)
    kw = {"n_lambdas": 6, "tol": 1e-13, "max_iter": 200_000, field: value}
    rj, rt, _ = _run_both(X, y, sizes, kw)
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-8)
    assert np.abs(rt.betas).max() > 0.01
    _assert_counters_equal(rj, rt)


def test_kernels_active_rule():
    from repro_torch.core.path_engine import _kernels_active
    for dev in ("cpu", "cuda"):
        assert not _kernels_active(True, torch.float64, dev)
        assert not _kernels_active(None, torch.float64, dev)
        assert _kernels_active(True, torch.float32, dev)
        assert not _kernels_active(False, torch.float32, dev)
    assert _kernels_active(None, torch.float32, "cuda")
    assert not _kernels_active(None, torch.float32, "cpu")


def test_path_result_converts_to_numpy():
    X, y, sizes = make_problem()
    res = T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu")).path(
        T.Plan(n_lambdas=5, tol=1e-8))
    out = convert.path_result(res)
    assert out["betas"].shape == (5, 60) and out["lambdas"].shape == (5,)
    assert out["n_segments"] == res.stats.n_segments
