"""The port's resource audit (``repro_torch.analysis.resource_audit``), the
counterpart of ``repro.analysis.resource_audit``, mirroring the resource
tests of ``tests/test_analysis.py`` and the cost tests of
``tests/test_hlo_analysis.py``.

Held to the reference where its parts still run here: the capacity keys
(``_capacity_key``), the residents and transfers of ``_args_for_key`` field
by field (the port's spec holds int64 indices, float64 group weights and
two more fields, named below), ``verify_shard_layout``.  The envelope is
held to closed forms and to the live bytes of a real CPU run (the card's
allocator holds it in ``chip_smoke.py``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis import compile_audit as cka
from repro_torch.analysis import resource_audit as ra
from repro_torch.launch import cost_analysis as ca

CPU = "cpu"
_BUDGETS = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                        "repro_torch", "analysis", "budgets.json")


def _plan(**kw):
    from repro_torch.core.problem import Plan
    return Plan(**kw)


def test_resource_audit_repo_clean():
    """The representative configurations fit the committed budgets: under
    the card's memory, collective-free fold sweeps, all-reduce-only feature
    shards, divisible layouts, transfers within their envelopes."""
    assert ra.run(budgets=_BUDGETS, device=CPU) == []


def test_seeded_oversized_bucket_breaches_hbm():
    key = ("sgl", 1000, 1 << 26, 1 << 22, "torch.float64", 1000, 10, False,
           1 << 26, (1 << 22) + 1, 16, 64, "squared")
    card = ra.card_for_key(key, "seeded-oversize", device=CPU)
    assert card.peak_bytes > ra.DEFAULT_BUDGETS["device_hbm_bytes"]
    found = ra.check_cards([card], ra.DEFAULT_BUDGETS)
    assert [f.rule for f in found] == ["resource/hbm-over-budget"]


@pytest.mark.parametrize("mesh_size,n_folds", [(4, 5), (4, 8), (1, 5),
                                               (2, 5), (3, 9), (2, 4)])
def test_verify_shard_layout_equals_reference(mesh_size, n_folds):
    from repro.analysis import resource_audit as ref
    got = ra.verify_shard_layout(mesh_size, n_folds, "layout")
    want = ref.verify_shard_layout(mesh_size, n_folds, "layout")
    assert [(f.rule, f.location) for f in got] == \
        [(f.rule, f.location) for f in want]


def test_seeded_transfer_regression_is_caught():
    key = ("nn", 50, 200, "torch.float64", 100, 10, False, 64, 8, "squared")
    card = ra.card_for_key(key, "seeded-transfer", device=CPU)
    budgets = dict(ra.DEFAULT_BUDGETS)
    budgets["configs"] = {"seeded-transfer":
                          {"peak_bytes": card.peak_bytes,
                           "transfer_bytes": card.transfer_bytes // 2}}
    found = ra.check_cards([card], budgets)
    assert [f.rule for f in found] == [
        "resource/transfer-in-segment-regression"]
    budgets["configs"]["seeded-transfer"]["transfer_bytes"] = \
        card.transfer_bytes
    assert ra.check_cards([card], budgets) == []


def _leaky_plan_child(n):
    """In a fake world of ``n`` ranks: a fold body with a cross-fold
    all-reduce smuggled in, counted."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import abstract_fold_mesh, fake_world
    with fake_world(n):
        mesh = abstract_fold_mesh(n)
        with ca.CostCounter() as c:
            v = torch.ones(4, 8)
            total = v.sum()
            dist.all_reduce(total, group=mesh.fold_group)
            v - total
    return {k: dict(e) for k, e in c.collectives.items()}


def test_seeded_collective_in_fold_body_is_caught():
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(1) as pool:
        colls = pool.apply(_leaky_plan_child, (2,))
    assert colls["all-reduce"]["count"] == 1
    card = ra.card_for_key(
        ("nn-folds", 4, 20, 40, "torch.float32", 100, 10, None, 16, 4, False,
         "squared"), "seeded-collective", device=CPU)
    card = dataclasses.replace(card, collectives=colls)
    found = ra.check_cards([card], ra.DEFAULT_BUDGETS)
    assert [f.rule for f in found] == ["resource/unexpected-collective"]
    allowed = dict(ra.DEFAULT_BUDGETS, allowed_collectives=["all-reduce"])
    assert ra.check_cards([card], allowed) == []


def test_collective_plans_fold_empty_feature_all_reduce_only():
    """The fold sweep's pieces on a 2-rank fold mesh fire nothing; the
    feature shards' screen, certification and partial fit all-reduce only
    (the reference's psum-only rule), on fake worlds, in one spawn."""
    plan = _plan(n_lambdas=12, n_folds=4, feature_shards=4)
    sgl = cka.ProblemShape(N=40, p=96, G=24, max_size=4, penalty="sgl",
                           dtype="torch.float64")
    nn = cka.ProblemShape(N=40, p=96, G=0, max_size=0, penalty="nn_lasso",
                          dtype="torch.float64")
    fold = ra.dominating_key(sgl, plan, "cv", n_folds=4, device=CPU)
    feats = [ra.dominating_key(s, plan, "path", device=CPU)
             for s in (sgl, nn)]
    assert [k[0] for k in feats] == ["sgl-feat", "nn-feat"]
    plans = ra.collective_plans([(fold, 2)] + [(k, 4) for k in feats],
                                device=CPU)
    assert plans[0] == {}
    for p in plans[1:]:
        assert set(p) == {"all-reduce"} and p["all-reduce"]["count"] >= 2
    with pytest.raises(ValueError):
        ra.fold_collective_plan(feats[0])
    with pytest.raises(ValueError):
        ra.feature_collective_plan(fold)


_CAPACITY_CASES = [
    ("sgl", "float32", "path", 1 << 18, 16384, 0),
    ("sgl", "float64", "cv", 1 << 17, 4096, 0),
    ("sgl", "float64", "path", 1 << 18, None, 0),
    ("nn_lasso", "float32", "path", 1 << 18, 16384, 0),
    ("nn_lasso", "float64", "cv", 1 << 17, None, 0),
    ("sgl", "float32", "path", 80 * 4096, 16384, 8),
    ("nn_lasso", "float64", "path", 1 << 18, 16384, 8),
]


@pytest.mark.parametrize("case", _CAPACITY_CASES)
def test_capacity_keys_equal_reference(case):
    """Every dimension of the port's capacity key is the reference's; the
    port's keys add the ``kernels`` flag and the loss, and spell the dtype
    as torch does."""
    from repro.analysis import resource_audit as ref
    from repro.core.problem import Plan as RefPlan
    penalty, dtype, mode, p, survivors, shards = case
    kw = dict(N=250, group_size=10, survivors=survivors,
              feature_shards=shards)
    got = ra.key_dims(ra._capacity_key(penalty, dtype, mode, p,
                                       plan=_plan(n_lambdas=8), **kw))
    want = ref._capacity_key(penalty, dtype, mode, p,
                             plan=RefPlan(n_lambdas=8), **kw)
    assert got.kind == want[0]
    if want[0] == "sgl":
        (_, N, P, G, dt, mi, ce, _pal, p_b, g_b, ms, len2) = want
        Ka, S = 1, 0
    elif want[0] == "nn":
        (_, N, P, dt, mi, ce, _pal, p_b, len2) = want
        G, g_b, ms, Ka, S = 0, 0, 1, 1, 0
    elif want[0] == "sgl-folds":
        (_, Ka, N, P, G, dt, mi, ce, _m, p_b, g_b, ms, len2, _c, _pal) = want
        S = 0
    elif want[0] == "nn-folds":
        (_, Ka, N, P, dt, mi, ce, _m, p_b, len2, _pal) = want
        G, g_b, ms, S = 0, 0, 1, 0
    elif want[0] == "sgl-feat":
        (_, S, N, P, G, dt, mi, ce, _m, p_b, g_b, ms, len2) = want
        Ka = 1
    else:
        (_, S, N, P, dt, mi, ce, _m, p_b, len2) = want
        G, g_b, ms, Ka = 0, 0, 1, 1
    assert (got.Ka, got.S, got.N, got.p, got.G, str(got.dtype)[6:],
            got.max_iter, got.check_every, got.p_b, got.g_b, got.max_size,
            got.len2) == (Ka, S, N, P, G, dt, mi, ce, p_b, g_b, ms, len2)


# The port's GroupSpec against the reference's, field by field: int32 index
# fields become int64 (x2), the group weights float64 whatever X's dtype,
# and two fields are the port's own.
_INDEX_FIELDS = ("sizes", "starts", "group_ids", "pad_index")
_REF_SPEC_FIELDS = ("sizes", "starts", "group_ids", "weights", "pad_index",
                    "pad_mask")


def _ref_fields(key):
    """Resident and transfer bytes of the reference's ``_args_for_key``,
    named as the port's fields."""
    from repro.analysis import resource_audit as ref
    _, args, resident = ref._args_for_key(key)
    kind = key[0]
    names = {"sgl": ["X", "X_sub", "y", "spec", "sub_spec", None,
                     "lipschitz", "lams", "valid", "beta0", None, None],
             "nn": ["X", "X_sub", "y", "lipschitz", "lams", "valid",
                    "beta0", None, None],
             "sgl-folds": ["X", "X_sub", "y", "spec", "sub_spec", None,
                           "lipschitz", "lams", "valid", "beta0", None,
                           "gap_scales", "mus"],
             "nn-folds": ["X", "X_sub", "y", "lipschitz", "lams", "valid",
                          "beta0", None, "gap_scales"]}[kind]
    res, h2d = {}, {}
    for name, a, r in zip(names, args, resident):
        if name is None:
            continue
        out = res if r else h2d
        if name in ("spec", "sub_spec"):
            leaves = a.tree_flatten()[0]
            for f, leaf in zip(_REF_SPEC_FIELDS, leaves):
                out[f"{name}.{f}"] = ref._tree_bytes(leaf)
        else:
            out[name] = ref._tree_bytes(a)
    return res, h2d


def _port_key(ref_key):
    """The port's key for the reference's (dtype spelled by torch, the
    kernels flag, the loss)."""
    kind = ref_key[0]
    k = list(ref_key)
    if kind == "sgl":
        k[4] = f"torch.{k[4]}"
        k[7] = False
        return tuple(k) + ("squared",)
    if kind == "nn":
        k[3] = f"torch.{k[3]}"
        return tuple(k) + ("squared",)
    if kind == "sgl-folds":
        k[5] = f"torch.{k[5]}"
        return tuple(k) + ("squared",)
    k[4] = f"torch.{k[4]}"
    return tuple(k) + ("squared",)


def _port_as_ref(fields, itemsize):
    """The port's field bytes in the reference's dtypes: int64 index fields
    halved, float64 group weights at X's item size, and the port's own
    fields (``pad_uncovered``, ``seg_lengths``) left out."""
    out = {}
    for name, b in fields.items():
        field = name.split(".")[-1]
        if field in ("pad_uncovered", "seg_lengths"):
            continue
        if "." in name and field in _INDEX_FIELDS:
            b //= 2
        if "." in name and field == "weights":
            b = b // 8 * itemsize
        out[name] = b
    return out


_REF_KEYS = [
    ("sgl", 250, 131072, 13107, "float32", 20000, 10, False, 16384, 2048, 10,
     64),
    ("sgl", 60, 128, 32, "float64", 200, 10, False, 64, 33, 4, 8),
    ("nn", 50, 200, "float64", 100, 10, False, 64, 8),
    ("sgl-folds", 4, 100, 500, 50, "float64", 20000, 10, None, 512, 33, 10,
     64, True, False),
    ("nn-folds", 4, 20, 40, "float32", 100, 10, None, 16, 4, False),
]


@pytest.mark.parametrize("ref_key", _REF_KEYS)
def test_residents_and_transfers_equal_reference(ref_key):
    ref_res, ref_h2d = _ref_fields(ref_key)
    key = _port_key(ref_key)
    isz = ra.key_dims(key).itemsize
    assert _port_as_ref(ra.resident_fields(key), isz) == ref_res
    assert _port_as_ref(ra.transfer_fields(key), isz) == ref_h2d


def test_reference_key_totals():
    """The reference's totals for the issue's key, and the port's: the
    port's spec is wider (int64, float64 weights, two more fields)."""
    ref_key = _REF_KEYS[0]
    ref_res, ref_h2d = _ref_fields(ref_key)
    assert sum(ref_res.values()) == 132_409_922
    assert sum(ref_h2d.values()) == 16_642_372
    key = _port_key(ref_key)
    G, p = 13107, 131072
    spec_extra = 4 * (2 * G + p + G * 10) + 4 * G + p + 8 * G
    assert sum(ra.resident_fields(key).values()) == 132_409_922 + spec_extra


def test_one_block_flops_closed_form():
    """One FISTA block's dot FLOPs are 4 N p_b a step (X z and X^T g) times
    ``check_every``, plus the restart's dot (2 p_b a step), plus the gap's;
    the priced card expands blocks by ``max_iter / check_every`` and rows
    by the chunk."""
    from repro_torch.core import solver
    from repro_torch.core.losses import SQUARED
    N, p_b, g_b, ce = 250, 512, 64, 50
    key = ("sgl", N, 10000, 1000, "torch.float32", 6000, ce, False, p_b,
           g_b, 10, 8, "squared")
    priced = ra.price_key(key, device=CPU, grid_len=100)
    with ca.fake_mode():
        X = torch.empty((N, p_b))
        y = torch.empty(N)
        spec = ra.fake_spec(g_b, p_b, 10, torch.device(CPU))
        beta = torch.zeros(p_b)
        one = torch.ones(())
        with ca.CostCounter() as c:
            from repro_torch.core.prox import sgl_prox
            solver._sgl_block(X, y, one, one.reshape(1), torch.ones(g_b),
                              lambda v, a, b: sgl_prox(spec, v, a, b), beta,
                              beta, one, ce, SQUARED)
        with ca.CostCounter() as g:
            solver._sgl_gap(X, y, spec, one, 0.5, beta, SQUARED)
    assert c.flops_by_op["mv"] == 4 * N * p_b * ce
    assert c.flops_by_op["dot"] == 2 * p_b * ce
    assert c.flops == 4 * N * p_b * ce + 2 * p_b * ce
    block = priced["pieces"]["block"]["flops"]
    assert block == c.flops + g.flops
    rows, blocks = 8, 6000 // ce
    once = sum(priced["pieces"][k]["flops"]
               for k in ("setup", "screen", "launch"))
    assert priced["flops"] == once + rows * (
        blocks * block + priced["pieces"]["certify"]["flops"])


def test_card_graph_term_on_the_card_route():
    """The card's float32 route captures the FISTA block: its statics are
    the graph term (a copy of X_sub, y and the sub-spec at least); the CPU's
    route captures nothing."""
    key = ("sgl", 250, 10000, 1000, "torch.float32", 6000, 50, True, 512,
           64, 10, 8, "squared")
    card = ra.card_for_key(key, device=None, grid_len=100)
    cpu = ra.card_for_key(key, device=CPU, grid_len=100)
    assert cpu.graph_bytes == 0
    assert card.graph_bytes >= 250 * 512 * 4 + 250 * 4 + sum(
        ra.spec_fields(64, 512, 10).values())
    assert card.graph_bytes == ra.graph_static_bytes(
        (250, 512, 64, 10, "torch.float32", 50, "squared", "cuda:0"))
    assert card.peak_bytes == (card.resident_bytes + card.graph_bytes
                               + card.excess_bytes + card.workspace_bytes)


def test_envelope_holds_a_real_run():
    """A real session on the CPU (path + CV) under the counter: its live
    bytes never exceed the envelope of the keys it paid (less the card's
    library workspaces)."""
    import repro_torch.core as T
    from repro_torch.data_synth import synthetic_sgl
    X, y, _ = synthetic_sgl(1, N=40, G=30, n=5, gamma1=0.1, gamma2=0.1,
                            seed=1)
    pp = T.Plan(alpha=1.0, n_lambdas=8, tol=1e-5, safety=1e-6,
                max_iter=500, check_every=50)
    cp = T.Plan(alpha=1.0, n_lambdas=8, n_folds=3, seed=0, tol=1e-5,
                safety=1e-5, max_iter=500, check_every=50)
    with ca.CostCounter() as c:
        sess = T.SGLSession(T.Problem.sgl(X, y, [5] * 30, device=CPU))
        sess.path(pp)
        sess.cv(cp)
    shape = cka.ProblemShape.of(sess.problem)
    env = ra.session_envelope(shape, sess.compile_keys, sess.fista_graphs,
                              device=CPU, grid_len=8, n_folds=3)
    assert 0 < c.peak <= env["total"] - env["workspace"]


def test_capacity_planner_monotone_and_positive():
    """Positive, screened >= unscreened, float32 >= float64, monotone in the
    budget and in the shards; the answer's card fits."""
    plan = _plan(n_lambdas=12, n_folds=4)
    kw = dict(plan=plan, N=200, group_size=8, survivors=1024, device=CPU)
    small = ra.capacity_max_p("sgl", "float64", "path", hbm_bytes=int(2e9),
                              **kw)
    big = ra.capacity_max_p("sgl", "float64", "path", hbm_bytes=int(4e9),
                            **kw)
    f32 = ra.capacity_max_p("sgl", "float32", "path", hbm_bytes=int(2e9),
                            **kw)
    unscreened = ra.capacity_max_p(
        "sgl", "float64", "path", hbm_bytes=int(2e9), plan=plan, N=200,
        group_size=8, survivors=None, device=CPU)
    two = ra.capacity_max_p("sgl", "float64", "path", hbm_bytes=int(2e9),
                            feature_shards=2, **kw)
    eight = ra.capacity_max_p("sgl", "float64", "path", hbm_bytes=int(2e9),
                              feature_shards=8, **kw)
    assert 0 < small <= big
    assert f32 >= small
    assert small >= unscreened > 0
    assert small <= two <= eight
    peak = ra._peak_at(small, "sgl", "float64", "path", N=200, group_size=8,
                       plan=plan, survivors=1024, device=CPU)
    assert peak <= int(2e9)


def test_capacity_searches_downward_when_first_probe_over():
    plan = _plan(n_lambdas=12, n_folds=4)
    got = ra.capacity_max_p("nn_lasso", "float64", "path", plan=plan,
                            hbm_bytes=int(2e8), N=200, group_size=8,
                            survivors=4096, device=CPU)
    assert got > 0
    assert ra._peak_at(got, "nn_lasso", "float64", "path", N=200,
                       group_size=8, plan=plan, survivors=4096,
                       device=CPU) <= int(2e8)


def test_capacity_cli_prints_rows(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--capacity", "--capacity-n", "100", "--hbm-gb", "1",
                 "--plan", "n_folds=2", "--plan", "n_lambdas=8",
                 "--device", CPU, "--json"]) == 0
    rows = [line for line in capsys.readouterr().out.splitlines() if line]
    assert len(rows) == 8
    assert all('"max_p_screened"' in r for r in rows)


def test_cli_default_device_needs_a_card():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--all"])


def test_counter_rounds_to_allocator_blocks_and_frees():
    with ca.CostCounter() as c:
        a = torch.ones(3)              # 12 bytes -> one 512-byte block
        b = a[1:]                      # a view: nothing new
        del a
        assert c.live == 512
        del b
    assert c.live == 0 and c.peak == 512
    assert ca.alloc_bytes(513) == 1024
    assert ca.wire_bytes("all-reduce", 100, 4) == 150.0
    assert ca.wire_bytes("reduce-scatter", 100, 4) == 300.0


def test_roofline_terms_use_the_card():
    cost = ca.Cost({"float32": 67e12, "bfloat16": 989e12}, 3.35e12, 450e9,
                   {})
    t = ca.roofline_terms(cost)
    assert t["device"] == ca.DEVICE_NAME
    assert t["t_compute"] == pytest.approx(2.0)
    assert t["t_memory"] == pytest.approx(1.0)
    assert t["t_collective"] == pytest.approx(1.0)
    assert t["dominant"] == "t_compute"
    assert np.isclose(ca.roofline_terms(cost, tf32=True)["t_compute"],
                      67 / 495 + 1)


def test_kernel_wrappers_fake_path_counts_no_launch():
    """On fake tensors each wrapper returns outputs of its kernel's shape
    and dtype, and the counter sees the kernel's operator, never a
    launch."""
    from repro_torch.kernels import ops
    key = ("sgl-folds", 2, 40, 200, 20, "torch.float32", 100, 10, None, 64,
           17, 10, 8, False, True, "squared")
    launches = ops.launch_counts()
    calls = ra.price_key(key, device=None, grid_len=8)["kernel_calls"]
    assert ops.launch_counts() == launches
    for name in ("xtv", "sgl_prox", "screen_norms_folds"):
        assert calls[name] > 0
    with ca.fake_mode():
        X = torch.empty((7, 5))
        out = ops.xtv(X, torch.empty(7))
    assert ca.is_fake(out) and out.shape == (5,) and \
        out.dtype == torch.float32


def test_cards_take_every_predicted_key_kind():
    """``card_for_key`` prices the keys ``compile_audit.predict_keys``
    makes, of every kind: the largest of each kind's universe on the
    card's device string (kernels and graphs on for float32)."""
    from repro_torch.launch.mesh import FoldMesh
    plan = _plan(n_lambdas=6, n_folds=2, max_iter=100)
    sgl = cka.ProblemShape(N=20, p=60, G=12, max_size=5, penalty="sgl",
                           dtype="torch.float32", device="cuda:0")
    nn = cka.ProblemShape(N=20, p=60, G=0, max_size=0, penalty="nn_lasso",
                          dtype="torch.float64")
    keys = set()
    for shape in (sgl, nn):
        for p in (plan, plan.with_(feature_shards=2),
                  plan.with_(center="per-fold") if shape is sgl else plan,
                  plan.with_(mesh=FoldMesh(("fold",), {"fold": 2}, (0, 1),
                                           {"fold": 0}))):
            keys |= cka.predict_keys(shape, p)
    largest = {}
    for k in keys:
        d = ra.key_dims(k)
        size = (d.Ka, d.p_b, d.g_b, d.len2, d.centered)
        if k[0] not in largest or size > largest[k[0]][0]:
            largest[k[0]] = (size, k)
    assert set(largest) == {"sgl", "sgl-feat", "sgl-folds", "nn", "nn-feat",
                            "nn-folds"}
    for _, k in largest.values():
        card = ra.card_for_key(k, device=CPU)
        assert card.peak_bytes > card.resident_bytes > 0
        assert card.flops > 0 and card.bytes_moved > 0
