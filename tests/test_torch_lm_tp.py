"""Tensor-parallel serving over 'model' (the reference dry run's
``tp_only`` layout) across ``torch.distributed`` ranks on the CPU
(``gloo``), against the live JAX reference and the port's single-process
steps.

The reduced dense GQA configs (``gemma2-2b``, ``gemma3-12b``,
``nemotron-4-340b``: 4 heads, 2 kv heads, vocabulary 256, window 32)
carry the reference's init across.  Two spawns run beside each other with
a ``file://`` rendezvous under ``tmp_path``: 2 ranks on (data 1, model 2),
then 4 ranks on (data 1, model 4), where the kv heads stay whole and each
rank holds one q head and reads one kv head, and on (data 2, model 2),
where each data group decodes its 2 of the 4 rows.  Each rank holds its
blocks by ``sharding.serving_pspecs`` and decodes 48 steps into a
64-slot cache, past the window, so the local layers' ring wraps.  Each
rank's logits are held within 1e-4 of the reference's ``forward_decode``
(the bar of ``test_torch_lm_model.py``'s decode tests) and within 1e-5 x
max|logits| of the port's single-process decode; the prefill step's last
logits the same against ``repro.launch.steps.make_prefill_step`` and the
port's.  Every step runs 2 all-reduces a layer (after ``wo`` and after
``w_out``), one for the embedding and one all-gather of the logits (and
one of the rows where the data axis splits the batch).  The MLA and MoE
configs are held the same way in ``tests/test_torch_lm_tp_mla_moe.py``;
the families outside tensor-parallel serving raise, naming their items.

The parent computes the single-process runs while the ranks work.  A
rank's spawned process imports this module, so the JAX imports stay inside
the parent-side functions.
"""
import datetime
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 150.0
ARCHS = ("gemma2-2b", "gemma3-12b", "nemotron-4-340b")
MESHES = {2: ({"data": 1, "model": 2},),
          4: ({"data": 1, "model": 4}, {"data": 2, "model": 2})}
CASES = [(w, i) for w in MESHES for i in range(len(MESHES[w]))]
B, T, CACHE, PROMPT = 4, 48, 64, 16
#: the MLA and MoE configs (``tests/test_torch_lm_tp_mla_moe.py``)
MLA_MOE = ("minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b")
OUTSIDE = ("zamba2-2.7b", "xlstm-350m", "seamless-m4t-medium",
           "llava-next-mistral-7b")
SPEC_MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16,
                                           "model": 16},
               {"data": 1, "model": 2}, {"data": 1, "model": 4},
               {"data": 2, "model": 2})


def _cfg(arch):
    from repro_torch.configs.base import get_config
    return get_config(arch).reduced()


def _tokens(cfg):
    return np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T))


def _mesh_name(shape):
    return "x".join(f"{a}{n}" for a, n in shape.items())


# -- one rank ---------------------------------------------------------------

def _serve(arch, tree, mesh):
    """This rank's decode and prefill of ``arch`` under the serving layout:
    its blocks of ``tree`` (the reference's parameters as numpy), 48
    teacher-forced steps through ``forward_decode(tp=True)``, the greedy
    tokens of ``make_serve_step(tp=True)`` over the prompt, and the
    prefill step's last logits."""
    from repro_torch import convert
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import model as TM
    from repro_torch.pytree import leaves
    cfg = _cfg(arch)
    shardings = sh.named(mesh, sh.serving_pspecs(cfg, mesh.shape))
    params = convert.lm_params(tree, "cpu", shardings)
    toks = torch.as_tensor(_tokens(cfg))
    caches = TM.init_cache(cfg, B, CACHE, torch.float32, "cpu",
                           tp_mesh_shape=mesh.shape)
    logits, counts = [], []
    with torch.no_grad():
        for t in range(T):
            sh.reset_collective_counts()
            lg, caches = TM.forward_decode(params, cfg, caches,
                                           toks[:, t:t + 1], t, mesh=mesh,
                                           compute_dtype=torch.float32,
                                           tp=True)
            counts.append(sh.collective_counts())
            logits.append(lg[:, 0].numpy())
    step = steps.make_serve_step(cfg, mesh=mesh, compute_dtype=torch.float32,
                                 tp=True)
    caches = TM.init_cache(cfg, B, CACHE, torch.float32, "cpu",
                           tp_mesh_shape=mesh.shape)
    greedy = []
    for t in range(PROMPT):
        nxt, caches = step(params, caches, toks[:, t:t + 1], t)
        greedy.append(nxt[:, 0].numpy())
    sh.reset_collective_counts()
    prefill = steps.make_prefill_step(cfg, mesh=mesh,
                                      compute_dtype=torch.float32, tp=True)(
        params, {"tokens": toks[:, :PROMPT]})
    return {"logits": np.stack(logits, 1), "counts": counts,
            "greedy": np.stack(greedy, 1), "prefill": prefill[:, 0].numpy(),
            "prefill_counts": sh.collective_counts(),
            "cache_k": tuple(caches["blocks"]["l0"].k.shape),
            "param_numel": sum(t.numel() for t in leaves(params))}


def _rank_main(rank, world, init_file, params_file, out_dir):
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(params_file, "rb") as f:
            trees = pickle.load(f)
        out = {}
        for shape in MESHES[world]:
            mesh = M.lm_mesh(shape)
            for arch in ARCHS:
                out[(_mesh_name(shape), arch)] = _serve(arch, trees[arch],
                                                        mesh)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _start(world, tmp, params_file):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, str(tmp / "rendezvous"), params_file, str(tmp)))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, tmp, deadline):
    try:
        for p in procs:
            p.join(max((deadline - datetime.datetime.now()).total_seconds(),
                       0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after " \
                         f"{JOIN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"rank exit codes {codes}"
    out = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the parent: the reference's and the port's single-process runs ---------

def _reference(arch, tree):
    """The reference's decode (48 steps of ``forward_decode`` into a
    64-slot cache, jitted) and prefill step, and the port's single-process
    twins, on ``tree``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget
    from repro.launch import steps as jsteps
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import model as TM
    jc, cfg = jget(arch).reduced(), _cfg(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(cfg)
    step = jax.jit(lambda p, c, t, pos: JM.forward_decode(
        p, jc, c, t, pos, compute_dtype=jnp.float32))
    jcache = JM.init_cache(jc, B, CACHE, jnp.float32)
    ref = []
    for t in range(T):
        lg, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32),
                          jnp.asarray(t, jnp.int32))
        ref.append(np.asarray(lg[:, 0]))
    ref_prefill = np.asarray(jsteps.make_prefill_step(
        jc, compute_dtype=jnp.float32)(
            jp, {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)}))[:, 0]
    params = convert.lm_params(tree, "cpu")
    caches = TM.init_cache(cfg, B, CACHE, torch.float32, "cpu")
    port = []
    with torch.no_grad():
        for t in range(T):
            lg, caches = TM.forward_decode(params, cfg, caches,
                                           torch.as_tensor(toks[:, t:t + 1]),
                                           t, compute_dtype=torch.float32)
            port.append(lg[:, 0].numpy())
    port_prefill = steps.make_prefill_step(cfg, compute_dtype=torch.float32)(
        params, {"tokens": torch.as_tensor(toks[:, :PROMPT])})[:, 0].numpy()
    return {"ref": np.stack(ref, 1), "port": np.stack(port, 1),
            "ref_prefill": ref_prefill, "port_prefill": port_prefill,
            "numel": sum(int(np.prod(a.shape))
                         for a in jax.tree.leaves(tree))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("tp")
    trees = {a: jax.tree.map(np.asarray, JM.init_params(
        jget(a).reduced(), jax.random.PRNGKey(i), jax.numpy.float32))
        for i, a in enumerate(ARCHS)}
    params_file = str(tmp / "params.pkl")
    with open(params_file, "wb") as f:
        pickle.dump(trees, f)
    dirs = {w: tmp / f"world{w}" for w in MESHES}
    for d in dirs.values():
        d.mkdir()
    procs = {w: _start(w, dirs[w], params_file) for w in MESHES}
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=JOIN_TIMEOUT_S)
    try:
        single = {a: _reference(a, trees[a]) for a in ARCHS}
    finally:
        ranks = {}
        for w in MESHES:
            ranks[w] = _join(procs[w], dirs[w], deadline)
    return single, ranks


def _per_rank(runs, world, i, arch):
    single, ranks = runs
    key = (_mesh_name(MESHES[world][i]), arch)
    return single[arch], [r[key] for r in ranks[world]]


def _counts_formula(arch, shape):
    """Every split: 2 all-reduces a layer and one for the embedding; one
    all-gather of the logits, one of the rows where 'data' splits them."""
    cfg = _cfg(arch)
    return {"all_reduce": 2 * cfg.num_layers + 1,
            "all_gather": 1 + (shape["data"] > 1), "reduce_scatter": 0}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: _mesh_name(
    MESHES[c[0]][c[1]]))
def test_tp_decode_matches_reference_and_one_process(runs, case, arch):
    one, ranks = _per_rank(runs, *case, arch)
    tol_port = 1e-5 * float(np.abs(one["port"]).max())
    for r in ranks:
        assert r["logits"].shape == one["ref"].shape
        np.testing.assert_allclose(r["logits"], one["ref"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["logits"], one["port"], rtol=0,
                                   atol=tol_port)
        np.testing.assert_array_equal(
            r["greedy"], np.argmax(one["port"][:, :PROMPT], axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: _mesh_name(
    MESHES[c[0]][c[1]]))
def test_tp_prefill_matches_reference_and_one_process(runs, case, arch):
    one, ranks = _per_rank(runs, *case, arch)
    tol_port = 1e-5 * float(np.abs(one["port_prefill"]).max())
    for r in ranks:
        np.testing.assert_allclose(r["prefill"], one["ref_prefill"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["prefill"], one["port_prefill"],
                                   rtol=0, atol=tol_port)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: _mesh_name(
    MESHES[c[0]][c[1]]))
def test_tp_collectives_and_blocks(runs, case, arch):
    """The collectives of every step and of the prefill follow the formula;
    each rank's cache holds its rows and the kv heads its q heads read, and
    its blocks sum to the tree over the split leaves."""
    shape = MESHES[case[0]][case[1]]
    one, ranks = _per_rank(runs, *case, arch)
    want = _counts_formula(arch, shape)
    cfg = _cfg(arch)
    m = shape["model"]
    kv = cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0 else 1
    for r in ranks:
        assert all(c == want for c in r["counts"])
        assert r["prefill_counts"] == want
        assert r["cache_k"] == (cfg.repeats, B // shape["data"],
                                min(CACHE, cfg.window_size)
                                if cfg.block_pattern[0] == "local"
                                else CACHE, kv, cfg.head_dim)
    assert all(r["param_numel"] == ranks[0]["param_numel"] for r in ranks)
    assert one["numel"] / m < ranks[0]["param_numel"] < one["numel"]


# -- no ranks ----------------------------------------------------------------

@pytest.mark.parametrize("arch", OUTSIDE)
def test_a_family_outside_the_slice_raises(arch):
    from repro_torch.launch import steps
    from repro_torch.models import model as TM
    cfg = _cfg(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP item (59|60)"):
        steps.make_serve_step(cfg, tp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        steps.make_prefill_step(cfg, tp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.forward_decode(None, cfg, None, None, 0, tp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.cache_shapes(cfg, 4, 64, tp_mesh_shape={"data": 1, "model": 2})


@pytest.mark.parametrize("arch", ARCHS + MLA_MOE + OUTSIDE)
def test_serving_pspecs_equal_the_references_tp_only_specs(arch):
    from repro.configs.base import get_config as jget
    from repro.models import common as JC
    from repro.models import model as JM
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.pytree import leaves
    import jax
    rules = dict(JC.DEFAULT_RULES)
    rules["embed"] = ()
    for shape in SPEC_MESHES:
        want = JC.tree_specs(JM.param_descs(jget(arch)), shape, rules)
        got = sh.serving_pspecs(get_config(arch), shape)
        assert [tuple(s) for s in leaves(got, is_leaf=sh.is_spec)] == \
            [tuple(s) for s in jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("H, KV, m, heads, kv, want", [
    (8, 4, 16, False, False, [(0, 4)] * 16),           # gemma2-2b at 16
    (16, 8, 16, True, False, [(r // 2, 1) for r in range(16)]),
    (96, 8, 16, True, False, [(r // 2, 1) for r in range(16)]),
    (96, 8, 4, True, True, [(2 * r, 2) for r in range(4)]),
    (4, 2, 4, True, False, [(r // 2, 1) for r in range(4)]),
])
def test_kv_block_maps_q_heads_to_their_kv_heads(H, KV, m, heads, kv, want):
    from repro_torch.models.attention import kv_block
    got = [kv_block(H, KV, m, r, heads, kv) for r in range(m)]
    assert got == want
    if heads:            # every local q head's kv head lies in the block
        for r, (first, n) in enumerate(got):
            hs = range(r * H // m, (r + 1) * H // m)
            assert all(first <= h // (H // KV) < first + n for h in hs)


@pytest.mark.parametrize("arch, m, heads, kv", [
    ("gemma3-12b", 2, True, True),
    ("gemma3-12b", 16, True, False),
    ("minicpm3-4b", 2, True, False),        # MLA: no wq, no wk
    ("minicpm3-4b", 16, False, False),      # 40 heads stay whole at 16
    ("deepseek-v2-236b", 16, True, False),
])
def test_head_split_reads_the_heads_from_wo(arch, m, heads, kv):
    """``HeadSplit.of`` reads the q heads from ``wo`` (both families) and
    the kv heads from ``wk`` where the layer has one; an MLA spec tree
    under a q LoRA has neither ``wq`` nor ``wk``, and its per-head
    weights split with ``wo``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.attention import HeadSplit
    cfg = get_config(arch)
    a = sh.serving_pspecs(cfg, {"data": 1, "model": m})["blocks"]["l0"][
        "attn"]
    a = {k: v[1:] for k, v in a.items()}            # the stack's dim off
    assert ("wq" in a, "wk" in a) == ((False, False) if cfg.mla
                                      else (True, True))
    assert tuple(HeadSplit.of(a, None))[1:] == (heads, kv)
    for name in ("wq_b", "wk_b", "wv_b") if cfg.mla else ("wq",):
        assert (a[name][1] == "model") == heads


def test_kv_block_refuses_heads_that_straddle_groups():
    from repro_torch.models.attention import kv_block
    with pytest.raises(NotImplementedError, match="straddle"):
        kv_block(12, 4, 6, 0, True, False)


def test_init_params_blocks_equal_the_unsplit_draw():
    """``init_params(shardings=...)`` draws every leaf in order and keeps
    this rank's block: the blocks are the slices of the unsplit init."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import model as TM
    from repro_torch.pytree import leaves
    cfg = _cfg("gemma3-12b")
    full = leaves(TM.init_params(cfg, torch.Generator().manual_seed(3)))
    shape = {"data": 1, "model": 2}
    specs = sh.serving_pspecs(cfg, shape)
    for m in range(2):
        mesh = LMMesh(("data", "model"), shape, range(2),
                      {"data": 0, "model": m}, {})
        shardings = sh.named(mesh, specs)
        got = leaves(TM.init_params(cfg, torch.Generator().manual_seed(3),
                                    shardings=shardings))
        for g, f, s in zip(got, full,
                           leaves(shardings, is_leaf=sh.is_sharding)):
            assert torch.equal(g, s.local(f))


def test_tp_without_a_mesh_is_the_plain_step():
    """``tp=True`` with no mesh splits nothing: the same logits."""
    from repro_torch.models import model as TM
    cfg = _cfg("gemma2-2b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(_tokens(cfg))
    out = []
    for tp in (False, True):
        caches = TM.init_cache(cfg, B, CACHE, torch.float32, "cpu")
        with torch.no_grad():
            for t in range(3):
                lg, caches = TM.forward_decode(
                    params, cfg, caches, toks[:, t:t + 1], t,
                    compute_dtype=torch.float32, tp=tp)
        out.append(lg)
    assert torch.equal(out[0], out[1])
