"""ZeRO-3 training, expert parallelism, ``seq_shard`` and elastic
checkpoints across ``torch.distributed`` ranks on the CPU (``gloo``),
against the port's run with no mesh and the live JAX reference.

Two spawns (2 ranks, then 4, a ``file://`` rendezvous under ``tmp_path``)
run every case of their world size in one go; the parent computes the
single-process runs while they work.  Reduced ``gemma2-2b`` (with the SGL
prox), ``granite-moe-1b-a400m`` and ``xlstm-350m`` train 2 steps on (2, 1),
(1, 2) and (2, 2) against no mesh, at the bars of
``test_microbatch_matches_full_batch`` (loss 1e-6 relative; the gradients
through the first moments, as that test reads them, and the parameters
``rtol=1e-5, atol=1e-9``).  Each trap where a rank's
local computation is not the reference's global one has its case:

1. the loss mean (every train case; B 3 on 2 data ranks, where each rank
   holds the whole batch);
2. the MoE's auxiliary (granite on (2, 1): aux and gradients);
3. MoE dispatch of the global batch (granite's layer at capacity factor
   1.0 on (2, 1), where tokens drop; a local capacity would drop others);
4. expert parallelism (granite's layer on (1, 2) and (2, 2) against the
   reference's ``moe_ffn_local`` summed over model shards, the emulation
   that a subprocess pins to the reference's ``shard_map`` at 0.0);
5. the global-norm clip (the gradients' norm is above the clip);
6. the SGL prox over sharded dims (gemma2's head and channel groups);
7. checkpoints: written on (1, 2), restored with no mesh and by the
   reference's ``restore``; ``train.main`` on 2 ranks resumed in one
   process, and one process's checkpoint resumed on 2 ranks;
   ``convert.lm_train_state`` with shardings;
8. ``gloo``'s ``reduce_scatter``: the gathers' backward over the data
   axes runs it (counted), with no other route.

Also ``seq_shard`` on (1, 2) (the layer boundaries' saved bytes halve),
``serve.main`` on 2 ranks (equal to one process) and the prefill step on
(2, 1) (each rank's rows, the logits gathered).
"""
import datetime
import os
import pickle
import subprocess
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 150.0
F32 = torch.float32
F64 = torch.float64            # the train cases' parameters and compute
LR = dict(base_lr=1e-3, warmup=1, total=10)
PROX = 3.0                       # sgl lambda (t = lr * lambda = 3e-3)
ARCHS = {"gemma2": "gemma2-2b", "granite": "granite-moe-1b-a400m",
         "xlstm": "xlstm-350m"}
# (B, S) a case trains at; granite's B S <= 8 is lossless dispatch on every
# mesh (an expert sees at most one pair a token, and capacity is >= 8)
SIZES = {"gemma2": (4, 16), "granite": (2, 4), "xlstm": (4, 16)}
EP_X = (4, 16)                   # the expert-parallel layer's input (B, S)


def _cfg(name):
    from repro_torch.configs.base import get_config
    return get_config(ARCHS[name]).reduced()


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1]),
            "labels": torch.as_tensor(toks[:, 1:])}


def _gathered(tree, shardings):
    from repro_torch.distributed import sharding as sh
    from repro_torch.pytree import leaves
    if shardings is None:
        return [t.detach().numpy().copy() for t in leaves(tree)]
    shs = leaves(shardings, is_leaf=sh.is_sharding)
    return [s.gather(t.detach()).numpy().copy()
            for t, s in zip(leaves(tree), shs)]


def _train(name, mesh, B=None, prox=0.0, seq_shard=False, remat="none",
           steps=2):
    """2 steps of ``make_train_step`` from the seed-0 init (state.step 2,
    so both steps move), the prox after each; the gradients' norm at the
    init first (through the train step's route).  Returns full arrays:
    the first moment after the first step (0.1 x its gradient) and the
    parameters at the end."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as S_
    from repro_torch.launch import train as T_
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    cfg = _cfg(name)
    B = B or SIZES[name][0]
    S = SIZES[name][1]
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), F64)
    sharded = mesh is not None and mesh.size > 1
    specs = TM.param_pspecs(cfg, mesh.shape) if sharded else None
    shardings = sh.named(mesh, adamw.state_pspecs(specs)) if sharded \
        else None
    if sharded:
        params = T_.local_params(params, shardings.params)
    state = adamw.init_state(params, F64)
    state = adamw.TrainState(torch.tensor(2, dtype=torch.int32),
                             *state[1:])
    # the gradient at the init, through the train step's own route
    params = state.params
    full = sh.gather_params(params, specs, TM.param_descs(cfg), mesh) \
        if sharded else params
    loss, _ = TM.forward_train(full, cfg, _batch(cfg, B, S, 10), mesh=mesh,
                               remat=remat, compute_dtype=F64,
                               seq_shard=seq_shard)
    grads = list(torch.autograd.grad(loss, leaves(params)))
    if sharded:
        sh.reduce_grads(grads, specs, mesh)
    grads = _gathered(grads, None if not sharded else shardings.params)
    step = S_.make_train_step(cfg, mesh=mesh, remat=remat,
                              compute_dtype=F64, lr_kwargs=LR,
                              seq_shard=seq_shard)
    out = {"loss": [], "ce": [], "aux": [], "grads": grads,
           "gnorm": float(np.sqrt(sum(float((g.astype(np.float64) ** 2)
                                            .sum()) for g in grads)))}
    for i in range(steps):
        state, m = step(state, _batch(cfg, B, S, 11 + i))
        for k in ("loss", "ce", "aux"):
            out[k].append(float(m[k]))
        if i == 0:        # 0.1 x the first step's gradient, as microbatch's
            out["m1"] = _gathered(state.m, shardings and shardings.m)
        if prox:
            T_.sgl_prox_step(state.params, cfg, LR["base_lr"] * prox,
                             LR["base_lr"] * prox, mesh, specs)
    out["params"] = _gathered(state.params, shardings and shardings.params)
    if prox:
        out["zeros"] = T_.prox_zeros(state.params, cfg, mesh, specs)
    return out


def _moe_layer(mesh, cf, B=None, S=None, dtype=F32):
    """granite's MoE layer (the init's first layer) on this rank's rows of
    a seeded global input: its rows of the output, the gradients of ``sum
    (out * R) + aux`` w.r.t. its rows of x and w.r.t. the full ``w_in``
    and ``router``, and aux."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMoE
    cfg = _cfg("granite")
    B, S = (B, S) if B else EP_X
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v.detach()[0].to(dtype).requires_grad_()
         for k, v in params["blocks"]["l0"]["ffn"].items()}
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model))
                        .astype(np.float32)).to(dtype)
    R = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model))
                        .astype(np.float32)).to(dtype)
    if mesh is not None and mesh.group(sh.dp_axes(mesh.shape)) is not None:
        rows = {"x": x, "R": R}
        rows, _ = sh.local_rows(rows, mesh)
        x, R = rows["x"], rows["R"]
    x = x.clone().requires_grad_()
    out, aux = TMoE.moe_forward(p, x, cfg, mesh=mesh, capacity_factor=cf)
    gx, gw, gr = torch.autograd.grad((out * R).sum() + aux,
                                     [x, p["w_in"], p["router"]])
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "gx": gx.numpy(), "gw_in": gw.numpy(), "grouter": gr.numpy()}


def _seq_bytes(mesh, seq_shard):
    """Bytes saved for backward by gemma2's stack under ``remat='full'``
    (the periods' boundaries: each checkpoint keeps its input), through
    ``saved_tensors_hooks``."""
    from repro_torch.models import model as TM
    cfg = _cfg("gemma2")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = SIZES["gemma2"]
    x = TM.embed_tokens(params, cfg, _batch(cfg, B, S, 10)["tokens"], F32)
    x = x.detach().requires_grad_()
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _, _ = TM.decoder_stack(params, x, torch.arange(S), cfg,
                                   mesh=mesh, remat="full",
                                   seq_shard=seq_shard)
    (y ** 2).sum().backward()
    return sum(saved), x.grad.numpy()


def _checkpoint(mesh, ckdir, ref_state):
    """One step on ``mesh``, then ``save`` with the shardings; and
    ``convert.lm_train_state`` of the reference's state, blocks gathered."""
    from repro_torch import convert
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as S_
    from repro_torch.launch import train as T_
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    cfg = _cfg("gemma2")
    specs = TM.param_pspecs(cfg, mesh.shape)
    shardings = sh.named(mesh, adamw.state_pspecs(specs))
    state = adamw.init_state(T_.local_params(TM.init_params(
        cfg, torch.Generator().manual_seed(0)), shardings.params))
    step = S_.make_train_step(cfg, mesh=mesh, compute_dtype=F32,
                              lr_kwargs=LR)
    state, _ = step(state, _batch(cfg, *SIZES["gemma2"], 11))
    ck.save(ckdir, 1, state, metadata={"mesh": sh.mesh_shape_dict(mesh)},
            shardings=shardings)
    blocks = convert.lm_train_state(ref_state, "cpu", shardings=shardings)
    return {"converted": _gathered(blocks, shardings),
            "block_shapes": [tuple(t.shape) for t in leaves(blocks.params)]}


MAIN_ARGV = ["--arch", "gemma2-2b", "--smoke", "--global-batch", "4",
             "--seq", "16", "--lr", "1e-2", "--sgl-lambda", "0.3",
             "--device", "cpu"]


def _train_main(argv):
    from repro_torch.launch import train as T_
    metrics = []
    losses = T_.main(argv, step_metrics=metrics)
    return {"losses": losses, "metrics": metrics}


def _prefill(mesh):
    """``make_prefill_step`` on reduced granite (B 4, S 16): each rank runs
    its rows and every rank returns the whole batch's last logits."""
    from repro_torch.launch import steps as S_
    from repro_torch.models import model as TM
    cfg = _cfg("granite")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    step = S_.make_prefill_step(cfg, mesh=mesh, compute_dtype=F32)
    return step(params, {"tokens": _batch(cfg, 4, 16, 12)["tokens"]}).numpy()


def _serve():
    from repro_torch.launch import serve
    return serve.main(["--arch", "gemma2-2b", "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--cache-len",
                       "16", "--device", "cpu"])


def _cases(world, tmp):
    """(name, mesh shape, run(mesh) -> result) per world size."""
    if world == 2:
        d2, m2 = {"data": 2, "model": 1}, {"data": 1, "model": 2}
        return [
            ("gemma2-2x1", d2, lambda m: _train("gemma2", m, prox=PROX)),
            ("gemma2-B3-2x1", d2, lambda m: _train("gemma2", m, B=3)),
            ("granite-2x1", d2, lambda m: _train("granite", m)),
            ("xlstm-2x1", d2, lambda m: _train("xlstm", m)),
            ("gemma2-1x2", m2, lambda m: _train("gemma2", m, prox=PROX)),
            ("granite-1x2", m2, lambda m: _train("granite", m)),
            ("xlstm-1x2", m2, lambda m: _train("xlstm", m)),
            ("dispatch-cf1-2x1", d2,
             lambda m: _moe_layer(m, 1.0, 8, 16, F64)),
            ("ep-1x2", m2, lambda m: _moe_layer(m, 1.25)),
            ("seq-1x2", m2, lambda m: {
                "train": _train("gemma2", m, seq_shard=True, remat="full"),
                "bytes": [_seq_bytes(m, s)[0] for s in (False, True)],
                "gx": _seq_bytes(m, True)[1]}),
            ("ckpt-1x2", m2, lambda m: _checkpoint(
                m, os.path.join(tmp, "ck12"),
                pickle.load(open(os.path.join(tmp, "ref_state.pkl"),
                                 "rb")))),
            ("main-2x1", d2, lambda m: _train_main(
                MAIN_ARGV + ["--steps", "2", "--ckpt-dir",
                             os.path.join(tmp, "ckmain"), "--ckpt-every",
                             "2"])),
            ("resume-2x1", d2, lambda m: _train_main(
                MAIN_ARGV + ["--steps", "3", "--resume", "--ckpt-dir",
                             os.path.join(tmp, "ckparent")])),
            ("serve-2x1", d2, lambda m: _serve()),
            ("prefill-2x1", d2, _prefill),
        ]
    d2m2 = {"data": 2, "model": 2}
    return [
        ("gemma2-2x2", d2m2, lambda m: _train("gemma2", m, prox=PROX)),
        ("granite-2x2", d2m2, lambda m: _train("granite", m)),
        ("xlstm-2x2", d2m2, lambda m: _train("xlstm", m)),
        ("ep-2x2", d2m2, lambda m: _moe_layer(m, 1.25)),
    ]


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = {}
        for name, shape, run in _cases(world, out_dir):
            mesh = M.lm_mesh(shape)
            sh.reset_collective_counts()
            res = run(mesh)
            if isinstance(res, dict):
                res["collectives"] = sh.collective_counts()
                res["coords"] = dict(mesh.coords)
            out[name] = res
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _start(world, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp_path / "rendezvous"),
                               str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, tmp_path):
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
    assert codes == [0] * len(procs), f"rank exit codes {codes}"
    out = []
    for r in range(len(procs)):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


# The xLSTM's recurrences compute in float32, as the reference's do, so its
# gradients carry float32 sums over the batch (the sLSTM's r_gates): they
# meet the bars, but where a gradient lies near AdamW's eps (1e-8) the
# update amplifies that noise, and two steps' parameters differ from one
# process by up to 7e-6 (2 data ranks).  The other models compute in
# float64 here and meet atol 1e-9 on the parameters too.
PARAM_ATOL = {"xlstm": 1e-5}


def _close_train(got, want, name):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6,
                               atol=1e-12, err_msg=name)
    for key in ("m1", "params"):
        assert len(got[key]) == len(want[key])
        atol = PARAM_ATOL.get(name.split("-")[0], 1e-9) \
            if key == "params" else 1e-9
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                       err_msg=f"{name} {key}")
    if "zeros" in want:
        assert got["zeros"] == want["zeros"], name


# ---------------------------------------------------------------------------
# the JAX side (imported in the parent only: the ranks load no JAX)
# ---------------------------------------------------------------------------

def _ref_state_numpy():
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    jc = jget(ARCHS["gemma2"]).reduced()
    js = jadamw.init_state(JM.init_params(jc, jax.random.PRNGKey(4)))
    js = js._replace(m=jax.tree.map(lambda a: a + 0.5, js.m))
    return jax.tree.map(np.asarray, js)


def _ep_emulation(n_data, n_model, cf=1.25, grads=True):
    """The reference's expert-parallel layer, emulated in one process: for
    each data block, ``moe_ffn_local`` summed over the model shards' expert
    slices at the per-shard capacity; the router (and aux) on the whole
    input.  Returns the output, aux and (``grads``) the gradients of
    ``_moe_layer``'s objective."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget
    from repro.models import moe as JMoE
    from repro_torch.models import model as TM
    jc = jget(ARCHS["granite"]).reduced()
    params = TM.init_params(_cfg("granite"), torch.Generator().manual_seed(0))
    p = {k: jnp.asarray(v.detach()[0].numpy())
         for k, v in params["blocks"]["l0"]["ffn"].items()}
    B, S = EP_X
    d, E, k = jc.d_model, jc.num_experts, jc.experts_per_token
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, S, d)).astype(np.float32))
    R = jnp.asarray(rng.standard_normal((B, S, d)).astype(np.float32))
    n_local = E // n_model
    b = B // n_data
    Tl = b * S
    cap = max(min(int(np.ceil(Tl * k / n_model * cf)), Tl * k), 8)

    def layer(x, w_in, router):
        q = dict(p, w_in=w_in, router=router)
        idx, gw, aux = JMoE.router_topk(q, x, jc)
        outs = []
        for db in range(n_data):
            sl = slice(db * b, (db + 1) * b)
            acc = 0.0
            for mi in range(n_model):
                es = slice(mi * n_local, (mi + 1) * n_local)
                acc = acc + JMoE.moe_ffn_local(
                    x[sl].reshape(Tl, d), idx[sl].reshape(Tl, k),
                    gw[sl].reshape(Tl, k), w_in[es], q["w_gate"][es],
                    q["w_out"][es], e_lo=mi * n_local, n_local=n_local,
                    capacity=cap, act=jc.mlp_act)
            outs.append(acc.reshape(b, S, d))
        return jnp.concatenate(outs), aux

    def objective(x, w_in, router):
        out, aux = layer(x, w_in, router)
        return jnp.sum(out * R) + aux

    out, aux = layer(x, p["w_in"], p["router"])
    res = dict(out=out, aux=aux)
    if grads:
        res.update(zip(("gx", "gw_in", "grouter"), jax.grad(
            objective, argnums=(0, 1, 2))(x, p["w_in"], p["router"])))
    return {k_: np.asarray(v) for k_, v in res.items()}


def _close_ep(ranks, want, shape, name):
    """Rank outputs (their rows), x gradients (rows), w_in gradients (summed
    over every rank) and router gradients (summed over the data ranks of
    model rank 0) against the emulation: outputs 1e-6, gradients 1e-5
    relative to their largest entry."""
    nd, nm = shape
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in ranks}
    out = np.concatenate([by[(d, 0)]["out"] for d in range(nd)])
    gx = np.concatenate([by[(d, 0)]["gx"] for d in range(nd)])
    for d in range(nd):            # every model rank holds the same rows
        for m in range(nm):
            np.testing.assert_array_equal(by[(d, m)]["out"],
                                          by[(d, 0)]["out"])
    gw = sum(r["gw_in"] for r in ranks)
    gr = sum(by[(d, 0)]["grouter"] for d in range(nd))
    aux = sum(by[(d, 0)]["aux"] for d in range(nd))
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert rel(out, want["out"]) <= 1e-6, (name, rel(out, want["out"]))
    for got, key in ((gx, "gx"), (gw, "gw_in"), (gr, "grouter")):
        assert rel(got, want[key]) <= 1e-5, (name, key, rel(got, want[key]))
    assert abs(aux - float(want["aux"])) <= 1e-6 * abs(float(want["aux"]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_two_ranks(tmp_path):
    """Every case of the 2-rank spawn against one process."""
    from repro.checkpoint import checkpointer as jckpt
    from repro_torch.checkpoint import checkpointer as tckpt
    from repro_torch.launch import train as T_
    ref_state = _ref_state_numpy()
    with open(tmp_path / "ref_state.pkl", "wb") as f:
        pickle.dump(ref_state, f)
    # a step-2 checkpoint with no mesh, for the ranks to resume
    _one_thread(lambda: T_.main(MAIN_ARGV + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "ckparent"),
        "--ckpt-every", "2"]))
    procs = _start(2, tmp_path)
    try:
        single = _one_thread(lambda: {
            name: run(None) for name, _, run in _cases(2, str(tmp_path))
            if not name.startswith(("ckpt", "main", "resume", "ep"))})
        ep = _ep_emulation(1, 2)
    finally:
        ranks = _join(procs, tmp_path)

    for name, want in single.items():
        if name.startswith(("gemma2", "granite", "xlstm")):
            for r in ranks:
                _close_train(r[name], want, name)
    # 5: the clip engaged (trap 5's case); 6: the prox zeroed elements
    assert single["gemma2-2x1"]["gnorm"] > 1.0
    assert all(v > 0 for v in single["gemma2-2x1"]["zeros"].values())
    # 8: the data axes' reduction ran on gloo's reduce_scatter
    for r in ranks:
        assert r["gemma2-2x1"]["collectives"]["reduce_scatter"] > 0
    # 3: global dispatch at capacity factor 1.0 drops tokens as one process
    # does; a rank-local capacity would drop others
    want = single["dispatch-cf1-2x1"]
    got = {k: np.concatenate([r["dispatch-cf1-2x1"][k] for r in ranks])
           for k in ("out", "gx")}
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got["gx"], want["gx"], rtol=1e-5, atol=1e-9)
    for k in ("gw_in", "grouter"):
        np.testing.assert_allclose(sum(r["dispatch-cf1-2x1"][k]
                                       for r in ranks), want[k],
                                   rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(sum(r["dispatch-cf1-2x1"]["aux"]
                                   for r in ranks), want["aux"], rtol=1e-6)
    assert _dropped_differently(), "capacity 1.0 dropped no token"
    # 4: expert parallelism against the reference's emulation
    _close_ep([r["ep-1x2"] for r in ranks], ep, (1, 2), "ep-1x2")
    # seq_shard: the losses of no mesh, half the boundary bytes
    for r in ranks:
        _close_train(r["seq-1x2"]["train"], single["seq-1x2"]["train"],
                     "seq-1x2")
        full, half = r["seq-1x2"]["bytes"]
        assert half * 2 == full and full == single["seq-1x2"]["bytes"][0]
        np.testing.assert_allclose(r["seq-1x2"]["gx"], single["seq-1x2"]
                                   ["gx"], rtol=1e-5, atol=1e-9)
    # 7: the (1, 2) checkpoint restores with no mesh and in the reference
    ck = str(tmp_path / "ck12")
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    cfg = _cfg("gemma2")
    state0 = adamw.init_state(TM.init_params(cfg, torch.Generator()
                                             .manual_seed(0)))
    restored, manifest = tckpt.restore(ck, 1, state0)
    assert manifest["metadata"]["mesh"] == {"data": 1, "model": 2}
    one = _one_thread(lambda: _one_step_state())
    from repro_torch.pytree import leaves
    for a, b in zip(leaves(restored), leaves(one)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-9)
    import jax
    jref = _ref_state_numpy()
    jres, _ = jckpt.restore(ck, 1, jref)
    for a, b in zip(jax.tree.leaves(jres), leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    # convert.lm_train_state with shardings: the blocks gathered are the
    # reference's tree, leaf for leaf
    for r in ranks:
        for a, b in zip(r["ckpt-1x2"]["converted"], jax.tree.leaves(jref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert ranks[0]["ckpt-1x2"]["block_shapes"] != [
        tuple(t.shape) for t in leaves(state0.params)]
    # train.main on 2 ranks resumed in this process, and this process's
    # checkpoint resumed on the ranks: step 3 as one run
    full3 = _one_thread(lambda: T_.main(MAIN_ARGV + ["--steps", "3"]))
    for r in ranks:
        np.testing.assert_allclose(r["main-2x1"]["losses"], full3[:2],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["resume-2x1"]["losses"], full3[2:],
                                   rtol=1e-6)
    resumed = _one_thread(lambda: T_.main(MAIN_ARGV + [
        "--steps", "3", "--resume", "--ckpt-dir", str(tmp_path / "ckmain")]))
    np.testing.assert_allclose(resumed, full3[2:], rtol=1e-6)
    # serve.main on 2 ranks equals one process; so does the prefill step
    for r in ranks:
        np.testing.assert_array_equal(r["serve-2x1"], single["serve-2x1"])
        np.testing.assert_allclose(r["prefill-2x1"], single["prefill-2x1"],
                                   rtol=1e-5, atol=1e-6)


def _one_step_state():
    """gemma2's state after one step with no mesh (``_checkpoint``'s)."""
    from repro_torch.launch import steps as S_
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    cfg = _cfg("gemma2")
    state = adamw.init_state(TM.init_params(cfg, torch.Generator()
                                            .manual_seed(0)))
    step = S_.make_train_step(cfg, compute_dtype=F32, lr_kwargs=LR)
    state, _ = step(state, _batch(cfg, *SIZES["gemma2"], 11))
    return state


def _dropped_differently() -> bool:
    """At capacity factor 1.0 on ``dispatch-cf1-2x1``'s input, one process
    drops pairs, and two rank-local windows (each half the global
    capacity) would keep another set: the trap the global dispatch
    avoids."""
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMoE
    cfg = _cfg("granite")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    p = {k: v.detach()[0] for k, v in params["blocks"]["l0"]["ffn"].items()}
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    E, k = cfg.num_experts, cfg.experts_per_token
    with torch.no_grad():
        idx, gw, _ = TMoE.router_topk(p, x, cfg)
        cap = TMoE.capacity_of(8 * 16, k, E, 1.0)
        counts = torch.bincount(idx.reshape(-1), minlength=E)
        glob = TMoE.moe_ffn_local(
            x.reshape(-1, cfg.d_model), idx.reshape(-1, k),
            gw.reshape(-1, k), p["w_in"], p["w_gate"], p["w_out"], e_lo=0,
            n_local=E, capacity=cap, act=cfg.mlp_act)
        half = torch.cat([TMoE.moe_ffn_local(
            x[h * 4:(h + 1) * 4].reshape(-1, cfg.d_model),
            idx[h * 4:(h + 1) * 4].reshape(-1, k),
            gw[h * 4:(h + 1) * 4].reshape(-1, k), p["w_in"], p["w_gate"],
            p["w_out"], e_lo=0, n_local=E,
            capacity=TMoE.capacity_of(4 * 16, k, E, 1.0), act=cfg.mlp_act)
            for h in range(2)])
    return bool(counts.max() > cap) and not torch.allclose(glob, half)


def test_four_ranks(tmp_path):
    """Every case of the 4-rank spawn ((data 2, model 2)) against one
    process and the expert-parallel emulation."""
    procs = _start(4, tmp_path)
    try:
        single = _one_thread(lambda: {
            name: run(None) for name, _, run in _cases(4, str(tmp_path))
            if not name.startswith("ep")})
        ep = _ep_emulation(2, 2)
    finally:
        ranks = _join(procs, tmp_path)
    for name, want in single.items():
        for r in ranks:
            _close_train(r[name], want, name)
    _close_ep([r["ep-2x2"] for r in ranks], ep, (2, 2), "ep-2x2")


def test_reference_shard_map_equals_the_emulation():
    """The reference's ``moe_forward`` under (1, 2) and (2, 2) meshes of 4
    forced host devices equals ``_ep_emulation``'s output at 0.0 (the
    emulation the card and the ranks are held to)."""
    code = """
import numpy as np, jax, jax.numpy as jnp, torch
from jax.sharding import Mesh
import test_torch_lm_zero_dist as Z
from repro.configs.base import get_config as jget
from repro.models import moe as JMoE
from repro_torch.models import model as TM
jc = jget(Z.ARCHS["granite"]).reduced()
params = TM.init_params(Z._cfg("granite"), torch.Generator().manual_seed(0))
p = {k: jnp.asarray(v.detach()[0].numpy())
     for k, v in params["blocks"]["l0"]["ffn"].items()}
B, S = Z.EP_X
x = jnp.asarray(np.random.default_rng(3).standard_normal(
    (B, S, jc.d_model)).astype(np.float32))
for nd, nm in ((1, 2), (2, 2)):
    mesh = Mesh(np.asarray(jax.devices()[:nd * nm]).reshape(nd, nm),
                ("data", "model"))
    out, aux = jax.jit(lambda p, x: JMoE.moe_forward(
        p, x, jc, mesh=mesh, capacity_factor=1.25))(p, x)
    want = Z._ep_emulation(nd, nm, grads=False)
    diff = float(np.abs(np.asarray(out) - want["out"]).max())
    assert diff == 0.0, (nd, nm, diff)
    assert float(aux) == float(want["aux"])
print("EMULATION-OK")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(root, "src"),
                                           os.path.join(root, "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EMULATION-OK" in out.stdout
