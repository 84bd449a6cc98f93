"""Tensor-parallel serving over 'model' for the MLA and MoE families (the
reference dry run's ``tp_only`` layout) across ``torch.distributed`` ranks
on the CPU (``gloo``), against the live JAX reference and the port's
single-process steps.

The reduced ``minicpm3-4b`` (MLA, dense), ``granite-moe-1b-a400m`` (GQA,
MoE) and ``deepseek-v2-236b`` (MLA, MoE with two shared experts, a dense
prologue layer): 4 heads, 8 experts, top 2, q / kv LoRA 32, vocabulary
256, with the reference's init carried across.  Two spawns run beside
each other with a ``file://`` rendezvous under ``tmp_path``: 2 ranks on
(data 1, model 2), then 4 ranks on (data 1, model 4) and (data 2, model
2).  Each rank holds its blocks by ``sharding.serving_pspecs`` (MLA's per-head
weights by heads, the latent and rope projections whole; the routed
experts by expert, the shared experts' channels by column and row) and
decodes 48 steps into a 64-slot cache: within 1e-4 of the reference's
``forward_decode`` and within 1e-5 x max|logits| of the port's
single-process decode (decode dispatches losslessly, so expert
parallelism equals one shard).  The dense MLA prefill holds the same bars
against ``repro.launch.steps.make_prefill_step`` without a mesh.  A MoE
prefill keeps the reference's per-shard capacity, so it is held within
1e-4 to the reference's prefill step under a JAX mesh of the same shape
(``shard_map`` over forced host devices, in a subprocess, as
``tests/test_torch_lm_zero_dist.py`` pins its emulation).  Every step runs
2 all-reduces a layer (after ``wo``; after ``w_out``, or a MoE layer's
one for its routed and shared partials together), one for the embedding
and one all-gather of the logits (and one of the rows where the data axis
splits the batch).

The parent computes the single-process runs while the ranks work.  A
rank's spawned process imports this module, so the JAX imports stay inside
the parent-side functions.
"""
import datetime
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 150.0
ARCHS = ("minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b")
MOE = ("granite-moe-1b-a400m", "deepseek-v2-236b")
MESHES = {2: ({"data": 1, "model": 2},),
          4: ({"data": 1, "model": 4}, {"data": 2, "model": 2})}
CASES = [(w, i) for w in MESHES for i in range(len(MESHES[w]))]
B, T, CACHE, PROMPT = 4, 48, 64, 16


def _cfg(arch):
    from repro_torch.configs.base import get_config
    return get_config(arch).reduced()


def _tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (B, T))


def _mesh_name(shape):
    return "x".join(f"{a}{n}" for a, n in shape.items())


def _shapes(tree):
    from repro_torch.pytree import leaves
    return [tuple(t.shape) for t in leaves(tree)]


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
    cache_shapes = _shapes(caches)
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
            "cache": cache_shapes,
            "blocks": [t.detach().numpy() for t in leaves(params)]}


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
                out[(_mesh_name(shape), arch)] = dict(
                    _serve(arch, trees[arch], mesh), coords=dict(mesh.coords))
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


# -- the reference's MoE prefill under a JAX mesh, in a subprocess ----------

_SHARD_MAP = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.launch import steps
params_file, out_file = sys.argv[1:3]
MOE, MESHES, PROMPT = {moe!r}, {meshes!r}, {prompt!r}
with open(params_file, "rb") as f:
    trees = pickle.load(f)
out = {{}}
for arch in MOE:
    jc = get_config(arch).reduced()
    p = jax.tree.map(jnp.asarray, trees[arch])
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (4, 48))
    batch = {{"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)}}
    for shape in MESHES:
        n = int(np.prod(list(shape.values())))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(
            tuple(shape.values())), tuple(shape))
        step = jax.jit(steps.make_prefill_step(
            jc, mesh=mesh, compute_dtype=jnp.float32))
        name = "x".join(f"{{a}}{{k}}" for a, k in shape.items())
        out[(name, arch)] = np.asarray(step(p, batch))[:, 0]
with open(out_file, "wb") as f:
    pickle.dump(out, f)
print("SHARD-MAP-OK")
"""


def _start_shard_map(params_file, out_file):
    """The reference's prefill step of each MoE config under a JAX mesh
    of each shape (4 forced host devices), started in a subprocess."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _SHARD_MAP.format(
        moe=MOE, prompt=PROMPT,
        meshes=[s for w in MESHES for s in MESHES[w]])
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"))
    return subprocess.Popen([sys.executable, "-c", code, params_file,
                             out_file], env=env, cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish_shard_map(proc, out_file):
    out, err = proc.communicate(timeout=JOIN_TIMEOUT_S)
    assert proc.returncode == 0 and "SHARD-MAP-OK" in out, err[-3000:]
    with open(out_file, "rb") as f:
        return pickle.load(f)


# -- the parent: the reference's and the port's single-process runs ---------

def _reference(arch, tree):
    """The reference's decode (48 steps of ``forward_decode`` into a
    64-slot cache, jitted) and prefill step without a mesh, and the port's
    single-process twins, on ``tree``; for the MoE configs also the port's
    decode with each shared-expert leaf cut to the rows of 'model' rank 0
    of 2 (what that rank would add unreduced)."""
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

    def port_decode(params):
        caches = TM.init_cache(cfg, B, CACHE, torch.float32, "cpu")
        out = []
        with torch.no_grad():
            for t in range(T):
                lg, caches = TM.forward_decode(
                    params, cfg, caches, torch.as_tensor(toks[:, t:t + 1]),
                    t, compute_dtype=torch.float32)
                out.append(lg[:, 0].numpy())
        return np.stack(out, 1)

    params = convert.lm_params(tree, "cpu")
    port_prefill = steps.make_prefill_step(cfg, compute_dtype=torch.float32)(
        params, {"tokens": torch.as_tensor(toks[:, :PROMPT])})[:, 0].numpy()
    res = {"ref": np.stack(ref, 1), "port": port_decode(params),
           "ref_prefill": ref_prefill, "port_prefill": port_prefill,
           "numel": sum(int(np.prod(a.shape))
                        for a in jax.tree.leaves(tree))}
    if cfg.num_shared_experts:
        half = cfg.moe_d_ff * cfg.num_shared_experts // 2
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.endswith("shared_out"):
                    p[..., half:, :] = 0.0
        res["unreduced"] = port_decode(params)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("tp_mla_moe")
    trees = {a: jax.tree.map(np.asarray, JM.init_params(
        jget(a).reduced(), jax.random.PRNGKey(10 + i), jax.numpy.float32))
        for i, a in enumerate(ARCHS)}
    params_file = str(tmp / "params.pkl")
    with open(params_file, "wb") as f:
        pickle.dump(trees, f)
    dirs = {w: tmp / f"world{w}" for w in MESHES}
    for d in dirs.values():
        d.mkdir()
    procs = {w: _start(w, dirs[w], params_file) for w in MESHES}
    sm_file = str(tmp / "shard_map.pkl")
    sm_proc = _start_shard_map(params_file, sm_file)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=JOIN_TIMEOUT_S)
    try:
        single = {a: _reference(a, trees[a]) for a in ARCHS}
    finally:
        ranks = {}
        for w in MESHES:
            ranks[w] = _join(procs[w], dirs[w], deadline)
        shard_map = _finish_shard_map(sm_proc, sm_file)
    return single, ranks, shard_map, trees


def _per_rank(runs, world, i, arch):
    single, ranks, shard_map, _ = runs
    key = (_mesh_name(MESHES[world][i]), arch)
    return single[arch], [r[key] for r in ranks[world]], shard_map.get(key)


def _counts_formula(arch, shape):
    """Every split (the reduced configs' dims all divide 2 and 4): 2
    all-reduces a layer, one for the embedding; one all-gather of the
    logits, one of the rows where 'data' splits them."""
    cfg = _cfg(arch)
    return {"all_reduce": 2 * cfg.num_layers + 1,
            "all_gather": 1 + (shape["data"] > 1), "reduce_scatter": 0}


CASE_IDS = lambda c: _mesh_name(MESHES[c[0]][c[1]])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_decode_matches_reference_and_one_process(runs, case, arch):
    one, ranks, _ = _per_rank(runs, *case, arch)
    tol_port = 1e-5 * float(np.abs(one["port"]).max())
    for r in ranks:
        assert r["logits"].shape == one["ref"].shape
        np.testing.assert_allclose(r["logits"], one["ref"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["logits"], one["port"], rtol=0,
                                   atol=tol_port)
        np.testing.assert_array_equal(
            r["greedy"], np.argmax(one["port"][:, :PROMPT], axis=-1))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_dense_mla_prefill_matches_reference_and_one_process(runs, case):
    one, ranks, _ = _per_rank(runs, *case, "minicpm3-4b")
    tol_port = 1e-5 * float(np.abs(one["port_prefill"]).max())
    for r in ranks:
        np.testing.assert_allclose(r["prefill"], one["ref_prefill"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["prefill"], one["port_prefill"],
                                   rtol=0, atol=tol_port)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_moe_prefill_matches_the_references_shard_map(runs, case, arch):
    """Per-shard capacity on the ranks, as the reference's ``shard_map``
    dispatches: within 1e-4 of its prefill under a mesh of the shape."""
    _, ranks, want = _per_rank(runs, *case, arch)
    assert want is not None and want.shape == ranks[0]["prefill"].shape
    for r in ranks:
        np.testing.assert_allclose(r["prefill"], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_moe_prefill_capacity_is_the_shards(runs, case):
    """The MoE prefill bar discriminates: ``deepseek-v2-236b``'s
    single-shard window drops pairs that the per-shard window keeps, so the
    one-process prefill (the port's and the reference's without a mesh)
    misses the ``shard_map`` prefill by far more than 1e-4."""
    one, _, want = _per_rank(runs, *case, "deepseek-v2-236b")
    for single in (one["port_prefill"], one["ref_prefill"]):
        assert float(np.abs(single - want).max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_collectives_a_step(runs, case, arch):
    """The collectives of every decode step and of the prefill follow the
    formula: one all-reduce per MoE layer, its routed and shared partials
    summed together."""
    shape = MESHES[case[0]][case[1]]
    _, ranks, _ = _per_rank(runs, *case, arch)
    want = _counts_formula(arch, shape)
    for r in ranks:
        assert all(c == want for c in r["counts"])
        assert r["prefill_counts"] == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tp_cache_and_blocks(runs, case, arch):
    """A rank's cache holds its rows and, under MLA, the whole latent
    (``kv_lora_rank``) and rope key; under GQA the kv heads its q heads
    read.  Its blocks are the slices of the tree by the serving specs, and
    the blocks of the 'model' ranks of a data group join into the tree."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.pytree import leaves
    shape = MESHES[case[0]][case[1]]
    _, ranks, _ = _per_rank(runs, *case, arch)
    cfg = _cfg(arch)
    rows, m = B // shape["data"], shape["model"]
    if cfg.mla:
        layer = [(cfg.repeats, rows, CACHE, cfg.kv_lora_rank),
                 (cfg.repeats, rows, CACHE, cfg.qk_rope_head_dim)]
    else:
        kv = cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0 else 1
        layer = [(cfg.repeats, rows, CACHE, kv, cfg.head_dim)] * 2
    pro = [s[1:] for s in layer] * len(cfg.prologue)
    for r in ranks:
        assert r["cache"] == layer + pro
    tree = runs[3][arch]
    import jax
    full = jax.tree.leaves(tree)
    specs = leaves(sh.serving_pspecs(cfg, shape), is_leaf=sh.is_spec)
    split = 0
    for i, (f, s) in enumerate(zip(full, specs)):
        dims = [d for d, e in enumerate(s) if e == "model"]
        assert len(dims) <= 1
        for r in ranks:
            blk = r["blocks"][i]
            if not dims:
                np.testing.assert_array_equal(blk, f)
                continue
            d, mi = dims[0], r["coords"]["model"]
            n = f.shape[d] // m
            np.testing.assert_array_equal(
                blk, np.take(f, range(mi * n, (mi + 1) * n), axis=d))
        if dims:
            split += 1
            group = sorted((r for r in ranks if r["coords"]["data"] == 0),
                           key=lambda r: r["coords"]["model"])
            np.testing.assert_array_equal(np.concatenate(
                [r["blocks"][i] for r in group], axis=dims[0]), f)
    numel = sum(b.size for b in ranks[0]["blocks"])
    one = runs[0][arch]
    assert split and one["numel"] / m < numel < one["numel"]


def test_an_unreduced_shared_expert_partial_fails_the_bar(runs):
    """What a rank of (data 1, model 2) would return if it added its
    shared-expert partial after the routed all-reduce, unsummed (its half
    of ``shared_out``'s rows alone): it misses the reference by more than
    the 1e-4 bar the ranks meet."""
    one = runs[0]["deepseek-v2-236b"]
    err = float(np.abs(one["unreduced"] - one["ref"]).max())
    assert err > 1e-2, err
    _, ranks, _ = _per_rank(runs, 2, 0, "deepseek-v2-236b")
    assert max(float(np.abs(r["logits"] - one["ref"]).max())
               for r in ranks) <= 1e-4 < err


# -- no ranks ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_check_tp_accepts_full_and_reduced(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM
    for cfg in (get_config(arch), _cfg(arch)):
        TM.check_tp(cfg)
        shapes = TM.cache_shapes(cfg, 8, 64, tp_mesh_shape={"data": 2,
                                                            "model": 2})
        assert shapes["blocks"]["l0"][0].shape[1] == 4


def test_moe_split_reads_the_shared_channels():
    """``ExpertSplit.of`` reads the shared experts' split from
    ``shared_out``; the routed experts split with |model| dividing E, as
    the spec of ``w_in`` says."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.moe import ExpertSplit
    strip = lambda t: {k: v[1:] for k, v in t.items()}
    for arch, m, shared in (("deepseek-v2-236b", 16, True),
                            ("deepseek-v2-236b", 3, True),
                            ("deepseek-v2-236b", 7, False),
                            ("granite-moe-1b-a400m", 2, False)):
        cfg = get_config(arch)
        ffn = strip(sh.serving_pspecs(cfg, {"data": 1, "model": m})[
            "blocks"]["l0"]["ffn"])
        assert ExpertSplit.of(ffn).shared == shared, (arch, m)
        assert (ffn["w_in"][0] == "model") == (cfg.num_experts % m == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_blocks_equal_the_unsplit_draw(arch):
    """``init_params(shardings=...)`` on the MLA LoRA leaves, the stacked
    experts and the shared experts: each rank's blocks are the slices of
    the unsplit init, on (data 1, model 2) and (data 1, model 4)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import model as TM
    from repro_torch.pytree import leaves
    cfg = _cfg(arch)
    full = leaves(TM.init_params(cfg, torch.Generator().manual_seed(3)))
    for m in (2, 4):
        shape = {"data": 1, "model": m}
        specs = sh.serving_pspecs(cfg, shape)
        for r in range(m):
            mesh = LMMesh(("data", "model"), shape, range(m),
                          {"data": 0, "model": r}, {})
            shardings = sh.named(mesh, specs)
            got = leaves(TM.init_params(cfg, torch.Generator().manual_seed(3),
                                        shardings=shardings))
            for g, f, s in zip(got, full,
                               leaves(shardings, is_leaf=sh.is_sharding)):
                assert torch.equal(g, s.local(f))
