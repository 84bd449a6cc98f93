"""The fold mesh in one process: ``repro_torch.launch.mesh``'s fold helpers
on the reference's cases, and ``Plan(mesh=make_fold_mesh(K))`` on ``.cv``,
``.refine``, ``.stability`` and ``SGLCV`` against the live JAX reference
and against the port without a mesh.

With no ``torch.distributed`` group, ``make_fold_mesh`` gives a mesh of
one rank, as the reference gives a one-device mesh on a one-device host,
and ``shard_over_folds`` returns the sweep itself: the mesh route is the
unsplit route, bit for bit.  ``tests/test_torch_fold_dist.py`` splits
folds across ranks.

Tolerances: float64 at tol 1e-11, betas and MSE within 1e-8 of the
reference; the port with and without a mesh bit for bit.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.launch import mesh as jmesh
from repro_torch import api as tapi
from repro_torch.launch import mesh as tmesh


class _FakeMesh:
    """A test double exposing only ``.size`` (tests/test_analysis.py)."""
    def __init__(self, size):
        self.size = size


class _FakeMesh2D:
    """A folds x features test double (shape dict + size)."""
    def __init__(self, fold, feature):
        self.shape = {"fold": fold, "feature": feature}
        self.size = fold * feature


@pytest.mark.parametrize("mesh,n_folds", [
    (_FakeMesh(1), 4), (_FakeMesh(2), 4), (_FakeMesh(2), 5),
    (_FakeMesh(4), 8), (_FakeMesh(4), 6), (_FakeMesh(3), 9),
    (_FakeMesh2D(2, 4), 2), (_FakeMesh2D(2, 4), 3), (_FakeMesh2D(2, 4), 4),
    (_FakeMesh2D(2, 4), 8), (_FakeMesh2D(1, 8), 4), (None, 4),
])
def test_fold_shard_rules_match_reference(mesh, n_folds):
    """``fold_axis_size`` and ``fold_shard_compatible`` on the reference's
    cases (``tests/test_analysis.py``'s 1-D doubles and the 2 x 4 folds x
    features regression), against the reference's functions."""
    assert tmesh.fold_axis_size(mesh) == jmesh.fold_axis_size(mesh)
    assert tmesh.fold_shard_compatible(mesh, n_folds) is \
        jmesh.fold_shard_compatible(mesh, n_folds)


@pytest.mark.parametrize("n_folds", [2, 3, 5, 10])
def test_make_fold_mesh_without_a_group_is_a_mesh_of_one(n_folds):
    """The reference's pattern (``tests/test_cv.py``): a 1-D 'fold' mesh;
    on one process its size is 1, as the reference's on one device."""
    mesh = tmesh.make_fold_mesh(n_folds)
    want = jmesh.make_fold_mesh(n_folds)
    assert mesh.axis_names == tuple(want.axis_names) == ("fold",)
    assert mesh.size == 1 and mesh.shape == {"fold": 1}
    assert tmesh.fold_axis_size(mesh) == 1
    assert not tmesh.fold_shard_compatible(mesh, n_folds)
    # equal meshes are one compile key
    assert mesh == tmesh.make_fold_mesh(n_folds)
    assert hash(mesh) == hash(tmesh.make_fold_mesh(n_folds))
    assert mesh != tmesh.FoldMesh(("fold",), {"fold": 2}, (0, 1),
                                  {"fold": 0})


def test_make_fold_feature_mesh_without_a_group():
    """No fold axis > 1 fits one process: ``None``, the reference's
    contract; one shard is the 1-D fold mesh."""
    assert tmesh.make_fold_feature_mesh(4, 2) is None
    assert tmesh.make_fold_feature_mesh(4, 1) == tmesh.make_fold_mesh(4)


def test_shard_over_folds_passthrough_on_a_mesh_of_one():
    """``tests/test_cv.py``'s pass-through: ``fn`` itself on a mesh of one
    and on no mesh, for the split and for the unsplit launch."""
    def f(x):
        return x + 1
    mesh = tmesh.make_fold_mesh(5)
    assert mesh.size == 1
    for m in (mesh, None, _FakeMesh(1)):
        assert tmesh.shard_over_folds(f, m, (0,)) is f
        assert tmesh.run_unsharded(f, m) is f


# ---------------------------------------------------------------------------
# The verbs with a mesh
# ---------------------------------------------------------------------------

def _sgl_problem(seed=4, N=40, G=16, n=4, k_active=4):
    """``tests/test_cv.py:_sgl_problem`` at the fold-mesh test's size."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, k_active, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


CV = dict(n_folds=3, n_lambdas=8, tol=1e-11, max_iter=100_000,
          min_bucket=32)


def _port_session():
    X, y, sizes = _sgl_problem()
    return T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu"))


def test_cv_with_fold_mesh_matches_reference():
    """``tests/test_cv.py:test_sgl_cv_with_fold_mesh_matches_plain``'s
    problem: the port's ``.cv`` with ``make_fold_mesh(3)`` against the
    reference's ``sgl_cv(..., mesh=make_fold_mesh(3))``, float64, betas
    and MSE within 1e-8, the counters equal."""
    import warnings
    from repro.core.cv import sgl_cv
    X, y, sizes = _sgl_problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = sgl_cv(X, y, J.GroupSpec.from_sizes(sizes), 1.0,
                      mesh=jmesh.make_fold_mesh(3), **CV)
    sess = _port_session()
    got = sess.cv(T.Plan(alpha=1.0, mesh=tmesh.make_fold_mesh(3), **CV))
    assert np.abs(got.fold_betas - want.fold_betas).max() <= 1e-8
    assert np.abs(got.mse_path - want.mse_path).max() <= 1e-8
    assert got.best_index == want.best_index
    for f in ("n_screens", "n_segments", "n_compilations", "n_rejected"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    # the mesh rides in every fold key; a fresh equal mesh pays nothing
    assert all(k[8] == tmesh.make_fold_mesh(3)
               for k in sess.compile_keys if k[0] == "sgl-folds")
    again = sess.cv(T.Plan(alpha=1.0, mesh=tmesh.make_fold_mesh(3), **CV))
    assert again.stats.n_compilations == 0


@pytest.mark.parametrize("penalty,kw", [
    ("sgl", dict(schedule="elastic")),
    ("sgl", dict(schedule="lockstep", center="per-fold")),
    ("nn_lasso", dict(schedule="elastic")),
])
def test_cv_with_fold_mesh_equals_no_mesh_bit_for_bit(penalty, kw):
    X, y, sizes = _sgl_problem()
    if penalty == "sgl":
        prob = T.Problem.sgl(X, y, sizes, device="cpu")
    else:
        prob = T.Problem.nn_lasso(np.abs(X), y, device="cpu")
    plan = T.Plan(**CV, **kw)
    a = T.SGLSession(prob).cv(plan)
    b = T.SGLSession(prob).cv(plan.with_(mesh=tmesh.make_fold_mesh(3)))
    np.testing.assert_array_equal(b.fold_betas, a.fold_betas)
    np.testing.assert_array_equal(b.mse_path, a.mse_path)
    assert b.stats.n_segments == a.stats.n_segments
    assert b.stats.buckets == a.stats.buckets


def test_refine_and_stability_with_fold_mesh_equal_no_mesh():
    """``.refine`` and ``.stability`` under ``Plan(mesh=...)``, against the
    port without a mesh: bit for bit."""
    mesh = tmesh.make_fold_mesh(3)
    out = []
    for m in (None, mesh):
        sess = _port_session()
        sess.cv(T.Plan(mesh=m, **CV))
        ref = sess.refine(factor=4.0, n_lambdas=6)
        stab = sess.stability(T.Plan(mesh=m, n_lambdas=6, min_ratio=0.1,
                                     n_subsamples=4, batch_size=2,
                                     tol=1e-10))
        out.append((ref, stab))
    (r0, s0), (r1, s1) = out
    np.testing.assert_array_equal(r1.fine.fold_betas, r0.fine.fold_betas)
    assert r1.lambda_ == r0.lambda_ and r1.index == r0.index
    np.testing.assert_array_equal(s1.selection_probs, s0.selection_probs)
    assert s0.selection_probs.max() > 0


def test_sglcv_with_fold_mesh_equals_no_mesh():
    X, y, sizes = _sgl_problem()
    kw = dict(groups=sizes, n_folds=3, n_lambdas=8, tol=1e-10,
              device="cpu")
    a = tapi.SGLCV(**kw).fit(X, y)
    b = tapi.SGLCV(mesh=tmesh.make_fold_mesh(3), **kw).fit(X, y)
    np.testing.assert_array_equal(b.coef_, a.coef_)
    assert b.lambda_ == a.lambda_
    assert b.get_params()["mesh"] == tmesh.make_fold_mesh(3)
