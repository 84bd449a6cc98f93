"""The port's audits, ``repro_torch.analysis``: the compile-key and
CUDA-graph universes against what port sessions pay, their sizes against
the reference's ``repro.analysis.compile_audit``, and the kernel checks
(mask coverage under 1e30 poison, the float64 gate).

On the CPU no FISTA graph is captured (``fista_graphs`` stays empty), so
the graph universe is held against the bucket shapes the engines pay,
read as the graph keys they would capture on the card; the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold real captures.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.analysis import compile_audit as jca
from repro_torch import analysis
from repro_torch.analysis import compile_audit as ca
from repro_torch.analysis import kernel_check as kc
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import FoldMesh, make_fold_mesh


def _small_problem():
    """``tests/test_analysis.py:_small_sgl_problem``: (X, y, sizes)."""
    rng = np.random.default_rng(0)
    N, p = 30, 48
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[:6] = rng.standard_normal(6)
    y = X @ beta + 0.05 * rng.standard_normal(N)
    return X, y, [4] * 12


def _session(plan, dtype=None):
    X, y, sizes = _small_problem()
    return T.SGLSession(T.Problem.sgl(X, y, sizes, device="cpu",
                                      dtype=dtype), plan)


def test_compile_keys_all_predicted():
    """Every key a port session pays (path + cv) is in the predicted
    universe, the session's counter agrees with its key set, and the
    universe is within the polylog budget."""
    plan = T.Plan(n_lambdas=12, n_folds=3, tol=1e-6, max_iter=2000)
    sess = _session(plan)
    sess.path()
    sess.cv()
    shape = ca.ProblemShape.of(sess.problem)
    universe = ca.predict_keys(shape, plan, kinds=("path", "cv"),
                               n_folds=3)
    assert {k[0] for k in sess.compile_keys} == {"sgl", "sgl-folds"}
    assert ca.verify_paid_keys(sess.compile_keys, universe) == []
    assert sess.stats.n_compilations == len(sess.compile_keys)
    assert len(universe) <= ca.budget(shape, plan, n_folds=3)
    assert ca.audit(shape, plan, n_folds=3) == []


def test_unpredicted_key_is_flagged():
    plan = T.Plan(n_lambdas=12, n_folds=3)
    sess = _session(plan)
    universe = ca.predict_keys(ca.ProblemShape.of(sess.problem), plan,
                               n_folds=3)
    bogus = ("sgl", 30, 48, 12, "torch.float64", 1, 1, False, 48, 12, 4, 1,
             "squared")
    found = ca.verify_paid_keys([bogus], universe)
    assert [f.rule for f in found] == ["compile/unpredicted-key"]


def test_feat_compile_keys_predicted_and_paid():
    """A feature-sharded session pays only predicted ``sgl-feat`` keys
    (they carry the kernels flag the reference's lack), within the
    doubled budget."""
    plan = T.Plan(n_lambdas=12, tol=1e-6, max_iter=2000, feature_shards=8)
    sess = _session(plan)
    sess.path()
    shape = ca.ProblemShape.of(sess.problem)
    universe = ca.predict_keys(shape, plan, kinds=("path",))
    assert any(k[0] == "sgl-feat" for k in sess.compile_keys)
    assert ca.verify_paid_keys(sess.compile_keys, universe) == []
    assert len(universe) <= ca.budget(shape, plan, kinds=("path",))


def test_fold_mesh_keys_carry_the_mesh():
    """``.cv`` under a fold mesh pays keys carrying it; the universe of
    that plan predicts them, and a plan with another mesh does not."""
    plan = T.Plan(n_lambdas=8, n_folds=3, tol=1e-8, mesh=make_fold_mesh(3))
    sess = _session(plan)
    sess.cv()
    shape = ca.ProblemShape.of(sess.problem)
    assert ca.verify_paid_keys(
        sess.compile_keys, ca.predict_keys(shape, plan, kinds=("cv",))) == []
    other = plan.with_(mesh=FoldMesh(("fold",), {"fold": 3}, (0, 1, 2),
                                     {"fold": 0}))
    found = ca.verify_paid_keys(
        sess.compile_keys, ca.predict_keys(shape, other, kinds=("cv",)))
    assert found and {f.rule for f in found} == {"compile/unpredicted-key"}


PLANS = {
    "default": dict(n_lambdas=12, n_folds=3),
    "per-fold": dict(n_lambdas=12, n_folds=3, center="per-fold"),
    "big-chunk": dict(n_lambdas=40, n_folds=4, chunk_init=32,
                      chunk_cap=128),
    "feat8": dict(n_lambdas=12, n_folds=3, feature_shards=8),
    "buckets": dict(n_lambdas=30, n_folds=5, min_bucket=8,
                    min_group_bucket=2),
}


@pytest.mark.parametrize("penalty,name", [
    (penalty, name) for penalty in ("sgl", "nn_lasso") for name in PLANS
    if penalty == "sgl" or "center" not in PLANS[name]])
def test_universe_size_equals_the_reference(penalty, name):
    """The port's key tuples differ from the reference's in layout only:
    for the same shape and plan the two universes have the same size."""
    kw = PLANS[name]
    G, max_size = (12, 4) if penalty == "sgl" else (0, 0)
    jshape = jca.ProblemShape(N=30, p=48, G=G, max_size=max_size,
                              penalty=penalty, dtype="float64")
    tshape = ca.ProblemShape(N=30, p=48, G=G, max_size=max_size,
                             penalty=penalty, dtype="torch.float64")
    want = jca.predict_keys(jshape, J.Plan(**kw))
    got = ca.predict_keys(tshape, T.Plan(**kw))
    assert len(got) == len(want) > 0
    assert len(got) <= ca.budget(tshape, T.Plan(**kw))


def _as_graph_keys(compile_keys, device="cuda:0"):
    """The graph key a float32 solve on the card would capture for each
    SGL bucket a session paid: (rows, p_b, G_b, max_size, dtype,
    check_every, loss, device)."""
    out = set()
    for k in compile_keys:
        if k[0] == "sgl":
            _, N, _, _, dtype, _, ce, _, p_b, g_b, ms, _, loss = k
        elif k[0] == "sgl-folds":
            (_, _, N, _, _, dtype, _, ce, _, p_b, g_b, ms, _, _, _,
             loss) = k
        else:
            continue
        out.add((N, p_b, g_b, ms, dtype, ce, loss, device))
    return out


def test_graph_universe_holds_the_buckets_paid():
    """A float32 session with the kernels on pays path and fold buckets;
    read as the graphs the card would capture, each is in the graph
    universe of the same shape on the card, and the universe is within
    the budget.  Float64, the CPU and feature weights capture none."""
    plan = T.Plan(n_lambdas=12, n_folds=3, tol=1e-5, max_iter=2000,
                  use_kernels=True)
    sess = _session(plan, dtype=torch.float32)
    sess.path()
    sess.cv()
    shape = ca.ProblemShape.of(sess.problem)
    assert sess.fista_graphs == {}             # the CPU captures nothing
    assert ca.predict_graph_keys(shape, plan) == set()
    card = ca.ProblemShape(**{**shape.__dict__, "device": "cuda:0"})
    universe = ca.predict_graph_keys(card, plan)
    paid = _as_graph_keys(sess.compile_keys)
    assert len(paid) >= 2
    assert ca.verify_paid_graphs(paid, universe) == []
    assert len(universe) <= ca.budget(card, plan)
    for other in (ca.ProblemShape(**{**card.__dict__,
                                     "dtype": "torch.float64"}),
                  ca.ProblemShape(**{**card.__dict__, "weighted": True})):
        assert ca.predict_graph_keys(other, plan) == set()


def test_unpredicted_graph_is_flagged():
    plan = T.Plan(n_lambdas=12, n_folds=3)
    card = ca.ProblemShape(N=30, p=48, G=12, max_size=4, penalty="sgl",
                           dtype="torch.float32", device="cuda:0")
    universe = ca.predict_graph_keys(card, plan)
    good = (30, 48, 12, 4, "torch.float32", 10, "squared", "cuda:0")
    bogus = (30, 37, 12, 4, "torch.float32", 10, "squared", "cuda:0")
    assert ca.verify_paid_graphs([good], universe) == []
    found = ca.verify_paid_graphs([good, bogus], universe)
    assert [f.rule for f in found] == ["compile/unpredicted-graph"]


def test_static_layers_are_clean():
    assert analysis.run_layers(("compile", "kernels"), device="cpu") == []
    from repro_torch.analysis.__main__ import main
    assert main(["--compile", "--kernels", "--device", "cpu"]) == 0


def test_audits_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--kernels"])
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.run_layers(("kernels",))
    with pytest.raises(RuntimeError, match="CUDA"):
        kc.mask_coverage()


def test_f64_gate_is_clean():
    assert kc.f64_gate() == []


def test_mask_coverage_is_clean_on_the_cpu():
    errors = {}
    assert kc.mask_coverage("cpu", errors) == []
    assert set(errors) == {"xtv", "screen_norms", "screen_norms_folds",
                           "dpc_screen_folds", "sgl_prox"}


def _leaky_screen_norms_folds(c, mask):
    """Reads every slot, masked or not."""
    K, L, G, n = c.shape
    return ref.screen_norms_folds_ref(c.reshape(K * L, G, n),
                                      torch.ones_like(mask))


def _leaky_screen_norms_gather(C, idx, mask):
    return ref.screen_norms_gather_ref(C, idx, torch.ones_like(mask))


def _leaky_sgl_prox(v, idx, mask, unc, t_l1, t_group):
    return ref.sgl_prox_flat_ref(v, idx, torch.ones_like(mask), t_l1,
                                 t_group)


@pytest.mark.parametrize("name,leaky", [
    ("screen_norms_folds", _leaky_screen_norms_folds),
    ("screen_norms_gather", _leaky_screen_norms_gather),
    ("sgl_prox", _leaky_sgl_prox),
])
def test_seeded_leaky_wrapper_is_caught(monkeypatch, name, leaky):
    """A wrapper that reads a masked slot lets the 1e30 poison through:
    mask coverage names it."""
    if name == "screen_norms_folds":
        def wrapper(c, mask):
            snorm2, cinf = leaky(c, mask)
            K, L = c.shape[:2]
            return snorm2.reshape(K, L, -1), cinf.reshape(K, L, -1)
    else:
        wrapper = leaky
    monkeypatch.setattr(ops, name, wrapper)
    found = kc.mask_coverage("cpu")
    want = "kernels." + name.replace("_gather", "")
    assert found and {f.rule for f in found} == {"kernels/mask-coverage"}
    assert {f.location for f in found} == {want}
