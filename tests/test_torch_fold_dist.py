"""The fold mesh across ``torch.distributed`` ranks: ``Plan(mesh=...)`` on
``.cv`` with 2 and 4 ``gloo`` ranks on the CPU, against the port's
single-process run (no mesh) and the reference's unsharded ``sgl_cv``.

Each test spawns its ranks once (``torch.multiprocessing``, a ``file://``
rendezvous under ``tmp_path``), runs every case in them, and joins them
within its own timeout.

* Every rank returns the same per-fold betas, kept sets and counters, and
  they equal the single-process run's bit for bit: each member's sweep is
  the same computation wherever it runs, and the gathered outputs carry
  its bits.
* The mesh's tally: every launch is split (``sharded``, one
  ``all_gather`` each) or run whole on every rank (``unsharded``, no
  collective); a 3-fold CV on a fold axis of 2 exercises the second.
* A 2 x 2 (fold, feature) mesh runs ``feature_shards=2`` over each fold
  coordinate's feature group, bit-equal to the stacked executor.
* A fold mesh that would leave ranks out (3 folds on 2 ranks, 6 on 4) is
  refused with ``ValueError``.
"""
import copy
import datetime
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp

import repro_torch.core as T

JOIN_TIMEOUT_S = 120.0
SIZES = (4,) * 12


def _sgl_problem(seed=4, N=36):
    rng = np.random.default_rng(seed)
    p = int(np.sum(SIZES))
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[:6] = rng.standard_normal(6)
    return X, X @ beta + 0.01 * rng.standard_normal(N)


def _nn_problem(seed=6, N=36, p=48):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.standard_normal((N, p)))
    beta = np.zeros(p)
    beta[rng.choice(p, 6, replace=False)] = np.abs(rng.standard_normal(6))
    return X, X @ beta + 0.01 * rng.standard_normal(N)


PLAN = dict(n_lambdas=8, min_ratio=0.05, tol=1e-11, max_iter=100_000,
            min_bucket=16, chunk_init=2)


def _case(penalty, n_folds, schedule="elastic", center="global",
          shards=0):
    """A CV case: ``run(mesh)`` returns its betas, kept sets, counters."""
    def run(mesh):
        if penalty == "sgl":
            X, y = _sgl_problem()
            prob = T.Problem.sgl(X, y, list(SIZES), device="cpu")
        else:
            X, y = _nn_problem()
            prob = T.Problem.nn_lasso(X, y, device="cpu")
        res = T.SGLSession(prob).cv(T.Plan(
            n_folds=n_folds, schedule=schedule, center=center,
            feature_shards=shards, mesh=mesh, **PLAN))
        st = res.stats
        return dict(betas=res.fold_betas, kept=res.kept_features,
                    mse=res.mse_path, stats=dict(
                        n_segments=st.n_segments, n_screens=st.n_screens,
                        n_compilations=st.n_compilations,
                        n_rejected=st.n_rejected,
                        fista_iters=st.fista_iters,
                        buckets=[tuple(int(v) for v in b)
                                 for b in st.buckets]))
    return run


# (case, the fold mesh each rank builds) per world size
CASES = {
    2: {
        "sgl-elastic": (_case("sgl", 4), ("fold", 4)),
        "sgl-lockstep": (_case("sgl", 4, "lockstep"), ("fold", 4)),
        "sgl-centered": (_case("sgl", 4, center="per-fold"), ("fold", 4)),
        "nn-elastic": (_case("nn_lasso", 4), ("fold", 4)),
        "nn-lockstep": (_case("nn_lasso", 4, "lockstep"), ("fold", 4)),
        "sgl-3-folds": (_case("sgl", 3, "lockstep"), ("fold", 2)),
    },
    4: {
        "sgl-2x2": (_case("sgl", 4, shards=2), ("fold-feature", 4, 2)),
    },
}


def _make_mesh(spec):
    from repro_torch.launch import mesh as M
    if spec[0] == "fold":
        return M.make_fold_mesh(spec[1])
    return M.make_fold_feature_mesh(spec[1], spec[2])


def _rank_main(rank, world, init_file, out_dir):
    """One rank: join the ``gloo`` group, run every case of this world
    size on its fold mesh with the tallies counted per case, write the
    results."""
    import torch.distributed as dist
    from repro_torch.distributed import feature_shard as fs
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for name, (run, mesh_spec) in CASES[world].items():
            mesh = _make_mesh(mesh_spec)
            M.reset_fold_counts()
            fs.reset_collective_counts()
            res = run(mesh)
            res["tally"] = M.fold_counts()
            res["collectives"] = fs.collective_counts()
            res["mesh"] = (mesh.axis_names, mesh.shape, mesh.coords)
            # a mesh is a handle: a deep copy (sklearn's clone of an
            # estimator's parameters) is the mesh itself
            res["copied"] = copy.deepcopy(mesh) is mesh
            out[name] = res
        # a world larger than the mesh is refused, not left idle
        try:
            M.make_fold_mesh(3 if world == 2 else 6)
            refused = False
        except ValueError:
            refused = True
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump((out, refused), f)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path):
    """Run ``_rank_main`` on ``world`` ranks; fail if any is still running
    after ``JOIN_TIMEOUT_S`` or exits non-zero.  Returns each rank's
    results."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp_path / "rendezvous"),
                               str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=JOIN_TIMEOUT_S)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after " \
                         f"{JOIN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            cases, refused = pickle.load(f)
        assert refused, f"rank {r}: a fold mesh left ranks out"
        out.append(cases)
    return out


def _single(world):
    """Every case of this world size in this process with no mesh (the
    stacked executor where feature-sharded), on one thread as the ranks
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: run(None) for name, (run, _) in CASES[world].items()}
    finally:
        torch.set_num_threads(n)


def _check_equal(got, want, name):
    np.testing.assert_array_equal(got["betas"], want["betas"], err_msg=name)
    np.testing.assert_array_equal(got["kept"], want["kept"], err_msg=name)
    np.testing.assert_array_equal(got["mse"], want["mse"], err_msg=name)
    assert got["stats"] == want["stats"], name


def _check_tally(res, name):
    """Each launch is split, with one gather, or run whole on every rank,
    with none."""
    t = res["tally"]
    assert t["sharded"] + t["unsharded"] == res["stats"]["n_segments"], name
    assert t["all_gather"] == t["sharded"], name


def test_two_ranks_equal_the_single_process_run_bit_for_bit(tmp_path):
    ranks = _spawn(2, tmp_path)
    single = _single(2)
    for name, res in ranks[0].items():
        assert np.abs(res["betas"]).max() > 0.05, name
        for other in ranks:
            _check_equal(other[name], res, name)
            assert other[name]["tally"] == res["tally"], name
        _check_equal(res, single[name], name)
        _check_tally(res, name)
        assert res["collectives"]["all_gather"] == 0, name
        assert res["copied"], name
    for r, rank in enumerate(ranks):
        assert rank["sgl-elastic"]["mesh"] == (("fold",), {"fold": 2},
                                               {"fold": r})
    # K = 4 over a fold axis of 2: lockstep launches split while an even
    # number of folds is ready; K = 3 runs its full cohorts unsplit
    for name in ("sgl-elastic", "sgl-lockstep", "nn-elastic",
                 "sgl-centered"):
        assert ranks[0][name]["tally"]["sharded"] > 0, name
    three = ranks[0]["sgl-3-folds"]["tally"]
    assert three["unsharded"] > 0, three


def test_two_ranks_match_the_reference_unsharded_cv():
    """The 2-rank float64 CV of the first test, against the reference's
    ``.cv`` with no mesh: betas within 1e-8.  The ranks equal the
    single-process run bit for bit (above), so that run stands in here."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import repro.core as J
    X, y = _sgl_problem()
    want = J.SGLSession(J.Problem.sgl(X, y, list(SIZES))).cv(
        J.Plan(n_folds=4, **PLAN))
    got = _single(2)["sgl-elastic"]
    assert np.abs(got["betas"] - want.fold_betas).max() <= 1e-8
    assert np.abs(got["mse"] - want.mse_path).max() <= 1e-8


def test_fold_feature_mesh_on_four_ranks(tmp_path):
    ranks = _spawn(4, tmp_path)
    single = _single(4)
    name = "sgl-2x2"
    for r, rank in enumerate(ranks):
        res = rank[name]
        assert res["mesh"] == (("fold", "feature"),
                               {"fold": 2, "feature": 2},
                               {"fold": r // 2, "feature": r % 2})
        _check_equal(res, single[name], name)
        _check_tally(res, name)
        # the screens run one block a rank over its feature group: one
        # host gather of the keep masks a stacked screen
        assert res["collectives"]["all_gather"] == \
            res["stats"]["n_screens"] > 0
    assert ranks[0][name]["tally"]["sharded"] > 0
