"""The distributed feature-shard executor: ``Plan(feature_shards=S)`` across
``S`` ``torch.distributed`` ranks (``gloo``, CPU tensors), one column block
a rank, against the stacked executor (every block in one process).

Each test spawns its ranks once (``torch.multiprocessing``, a ``file://``
rendezvous under ``tmp_path``, so no port can clash between test
workers), runs every case in them, and joins them within its own timeout.

* Every rank returns the same betas, kept sets and counters.
* Two ranks equal the stacked executor bit for bit (``a + b == b + a``);
  five ranks on ragged groups within 1e-8 (the backend's sum order), with
  equal kept sets.
* The collectives are the ones ``distributed.feature_shard`` names:
  ``all_gather`` once for the setup correlation, once a screen and once a
  segment (the certified ``c_prev``) on a path, once a stacked screen in
  CV; ``all_reduce_min`` (``all_reduce_max`` for the nonnegative Lasso)
  once a certified row; ``all_reduce_sum`` for the boundary normal and
  each Gap-Safe fit.
"""
import datetime
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp

import repro_torch.core as T
from repro_torch.core import cv as tcv

JOIN_TIMEOUT_S = 120.0


def _sgl_problem(seed=3, N=40, sizes=(6,) * 16):
    rng = np.random.default_rng(seed)
    p = int(np.sum(sizes))
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(len(sizes), 3, replace=False):
        w = max(int(sizes[g]) // 2, 1)
        beta[starts[g]:starts[g] + w] = rng.standard_normal(w)
    return X, X @ beta + 0.01 * rng.standard_normal(N), list(sizes)


def _nn_problem(seed=4, N=40, p=96):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.standard_normal((N, p)))
    beta = np.zeros(p)
    beta[rng.choice(p, 8, replace=False)] = np.abs(rng.standard_normal(8))
    return X, X @ beta + 0.01 * rng.standard_normal(N)


def _masks(N, K=3, seed=0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    masks = np.zeros((K, N))
    for k in range(K):
        masks[k, np.setdiff1d(perm, perm[k::K])] = 1.0
    return masks


RAGGED = (7, 11, 5, 13, 9, 8, 17, 6, 12, 8)
PATH = dict(n_lambdas=10, min_ratio=0.05, tol=1e-12, safety=1e-6,
            max_iter=100_000)


def _path_case(penalty, screen, shards, sizes=(6,) * 16):
    def run():
        if penalty == "sgl":
            X, y, sizes_ = _sgl_problem(sizes=sizes)
            prob = T.Problem.sgl(X, y, sizes_, device="cpu")
            plan = T.Plan(alpha=0.5, screen=screen, feature_shards=shards,
                          **PATH)
        else:
            X, y = _nn_problem()
            prob = T.Problem.nn_lasso(X, y, device="cpu")
            plan = T.Plan(screen=screen, feature_shards=shards, **PATH)
        res = T.SGLSession(prob).path(plan)
        return dict(betas=res.betas, kept=res.kept_features,
                    stats=_stats(res.stats))
    return run


def _fold_case(penalty, screen, shards, centered=False, sizes=(6,) * 16):
    def run():
        if penalty == "sgl":
            X, y, sizes_ = _sgl_problem(seed=5, N=45, sizes=sizes)
        else:
            X, y = _nn_problem(seed=6, N=45)
        masks = _masks(X.shape[0])
        Xt = torch.as_tensor(X)
        grid = np.geomspace(0.8, 0.1, 8) * float(np.abs(X.T @ y).max())
        kw = dict(screen=screen, tol=1e-11, max_iter=100_000,
                  schedule="lockstep", feature_shards=shards)
        if penalty == "sgl":
            spec = T.GroupSpec.from_sizes(sizes_, device="cpu")
            mus, yy = None, y
            if centered:
                mus = (masks @ X) / masks.sum(axis=1)[:, None]
                yy = y[None, :] - ((masks @ y) / masks.sum(axis=1))[:, None]
            out = tcv.sgl_fold_paths(Xt, yy, spec, 0.5, masks, grid,
                                     mus=mus, **kw)
        else:
            out = tcv.nn_fold_paths(Xt, y, masks, grid, **kw)
        betas, kept, _, stats, _ = out
        return dict(betas=betas, kept=kept, stats=_stats(stats))
    return run


def _stats(st):
    return dict(n_segments=st.n_segments, n_screens=st.n_screens,
                n_compilations=st.n_compilations, n_rejected=st.n_rejected,
                buckets=[tuple(int(v) for v in b) for b in st.buckets])


CASES = {
    2: {
        "sgl-tlfre": _path_case("sgl", "tlfre", 2),
        "sgl-gapsafe": _path_case("sgl", "gapsafe", 2),
        "nn-dpc": _path_case("nn_lasso", "dpc", 2),
        "nn-gapsafe": _path_case("nn_lasso", "gapsafe", 2),
        "sgl-cv-tlfre": _fold_case("sgl", "tlfre", 2),
        "sgl-cv-gapsafe-centered": _fold_case("sgl", "gapsafe", 2,
                                              centered=True),
        "nn-cv-gapsafe": _fold_case("nn_lasso", "gapsafe", 2),
    },
    5: {
        "sgl-ragged-tlfre": _path_case("sgl", "tlfre", 5, sizes=RAGGED),
        "sgl-ragged-cv-gapsafe": _fold_case("sgl", "gapsafe", 5,
                                            sizes=RAGGED),
    },
}


def _rank_main(rank, world, init_file, out_dir):
    """One rank: join the ``gloo`` group, run every case of this world
    size with the collectives counted per case, write the results."""
    import torch.distributed as dist
    from repro_torch.distributed import feature_shard as fs
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = {}
        for name, run in CASES[world].items():
            fs.reset_collective_counts()
            res = run()
            res["collectives"] = fs.collective_counts()
            out[name] = res
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
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
            out.append(pickle.load(f))
    return out


def _stacked(world):
    """Every case of this world size through the stacked executor, in
    this process, on one thread as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: run() for name, run in CASES[world].items()}
    finally:
        torch.set_num_threads(n)


def _rows_run(stats):
    """Rows certified: a segment's accepted rows, and the failed row when
    it stopped early."""
    return sum(k + (k < m) for _, _, m, k in stats["buckets"])


def _expected_collectives(name, stats):
    cv = "-cv" in name
    nn = name.startswith("nn")
    gapsafe = "gapsafe" in name
    n_screens = stats["n_screens"]
    if cv:
        fits = (2 if "centered" in name else 1) * n_screens * gapsafe
        return dict(all_gather=n_screens, all_reduce_sum=fits,
                    all_reduce_min=0, all_reduce_max=0)
    rows = _rows_run(stats)
    return dict(all_gather=1 + n_screens + stats["n_segments"],
                all_reduce_sum=(0 if nn else 1) + n_screens * gapsafe,
                all_reduce_min=0 if nn else rows,
                all_reduce_max=rows if nn else 0)


def _check_ranks_agree(ranks):
    first = ranks[0]
    for other in ranks[1:]:
        assert other.keys() == first.keys()
        for name, res in first.items():
            np.testing.assert_array_equal(other[name]["betas"], res["betas"],
                                          err_msg=name)
            np.testing.assert_array_equal(other[name]["kept"], res["kept"],
                                          err_msg=name)
            assert other[name]["stats"] == res["stats"], name
            assert other[name]["collectives"] == res["collectives"], name


def test_two_ranks_equal_the_stacked_executor_bit_for_bit(tmp_path):
    ranks = _spawn(2, tmp_path)
    _check_ranks_agree(ranks)
    stacked = _stacked(2)
    for name, res in ranks[0].items():
        want = stacked[name]
        assert np.abs(want["betas"]).max() > 0.05, name
        np.testing.assert_array_equal(res["betas"], want["betas"],
                                      err_msg=name)
        np.testing.assert_array_equal(res["kept"], want["kept"],
                                      err_msg=name)
        assert res["stats"] == want["stats"], name
        assert res["collectives"] == _expected_collectives(
            name, res["stats"]), name


def test_five_ranks_on_ragged_groups_match_the_stacked_executor(tmp_path):
    ranks = _spawn(5, tmp_path)
    _check_ranks_agree(ranks)
    stacked = _stacked(5)
    for name, res in ranks[0].items():
        want = stacked[name]
        assert np.abs(res["betas"] - want["betas"]).max() <= 1e-8, name
        np.testing.assert_array_equal(res["kept"], want["kept"],
                                      err_msg=name)
        assert res["stats"] == want["stats"], name
        assert res["collectives"] == _expected_collectives(
            name, res["stats"]), name


def test_the_stacked_executor_is_chosen_without_a_group():
    """No process group (or one of another size): the stacked executor,
    and ``make_feature_mesh`` gives ``None``."""
    from repro_torch.distributed import feature_shard as fs
    from repro_torch.launch.mesh import make_feature_mesh
    assert make_feature_mesh(4) is None and make_feature_mesh(1) is None
    assert fs.resolve_feature_mesh(4) is None
    ops = fs.feature_ops(4)
    assert ops.group is None and ops.shards == (0, 1, 2, 3)
