"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs:
``steps.SHAPES`` / ``shape_supported`` / ``input_specs``,
``model.abstract_params``, ``adamw.abstract_state`` and ``model_flops``
against the reference's for all ten configs and every shape (mirroring
``tests/test_hlo_analysis.py``'s cost checks for the port's operator
counter), and a reduced cell on a fake (data 2, model 1) world against a
real two-rank ``gloo`` step (the harness of
``tests/test_torch_lm_zero_dist.py``): the same collectives by kind, the
same FLOPs as ``FlopCounterMode``.

Tokens are int64 in the port (its index dtype; the reference's are int32)
and the decode step's position is an int (``forward_decode`` takes one;
the reference's is a 0-d int32).
"""
import datetime
import os
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.all_archs import ALL_ARCHS
from repro_torch.configs.base import get_config
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, steps
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw

CPU = "cpu"
MESHES = [{}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
JOIN_TIMEOUT_S = 150.0


def _ref_dryrun():
    """The reference's dry-run module, imported without leaving its
    512-device ``XLA_FLAGS`` behind for the rest of the process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _ref_cfg(arch):
    from repro.configs.base import get_config as ref_get
    return ref_get(arch)


def _dt(d) -> str:
    return str(d).replace("torch.", "")


def test_shapes_equal_reference():
    from repro.launch import steps as ref
    assert steps.SHAPES == ref.SHAPES


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shape_supported_and_model_flops_equal_reference(arch):
    from repro.launch import steps as ref_steps
    ref = _ref_dryrun()
    cfg, rcfg = get_config(arch), _ref_cfg(arch)
    for shape in steps.SHAPES:
        assert steps.shape_supported(cfg, shape) == \
            ref_steps.shape_supported(rcfg, shape)
        assert dryrun.model_flops(cfg, shape) == pytest.approx(
            ref.model_flops(rcfg, shape), rel=1e-12)


def _flat(tree):
    import jax
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_reference(arch):
    """Shapes, dtypes and ``P`` specs of every shape's inputs, on no mesh,
    one pod and two."""
    from repro.launch import steps as ref
    cfg, rcfg = get_config(arch), _ref_cfg(arch)
    mode = ca.fake_mode()
    for shape in steps.SHAPES:
        if not steps.shape_supported(cfg, shape)[0]:
            continue
        for mesh in MESHES:
            got = steps.input_specs(cfg, shape, mesh, mode=mode, device=CPU)
            want = ref.input_specs(rcfg, shape, mesh)
            assert (got["kind"], got["seq"], got["batch"]) == \
                (want["kind"], want["seq"], want["batch"])
            if got["kind"] != "decode":
                (g,), (w,) = got["args"], want["args"]
                assert sorted(g) == sorted(w)
                for k in g:
                    assert tuple(g[k].shape) == tuple(w[k].shape)
                    if k in ("tokens", "labels"):
                        assert (_dt(g[k].dtype), str(w[k].dtype)) == \
                            ("int64", "int32")
                    else:
                        assert _dt(g[k].dtype) == str(w[k].dtype)
                    assert tuple(got["arg_pspecs"][0][k]) == \
                        tuple(want["arg_pspecs"][0][k])
                continue
            caches, tokens, pos = got["args"]
            rc, rt, rp = want["args"]
            from repro_torch.pytree import leaves
            assert sorted((tuple(t.shape), _dt(t.dtype))
                          for t in leaves(caches)) == \
                sorted((tuple(t.shape), str(t.dtype)) for t in _flat(rc))
            assert tuple(tokens.shape) == tuple(rt.shape)
            assert tokens.dtype == torch.int64 and pos == want["seq"] - 1
            assert rp.shape == ()
            assert tuple(got["arg_pspecs"][1]) == \
                tuple(want["arg_pspecs"][1])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_and_state_equal_reference(arch):
    import jax.numpy as jnp
    from repro.models import model as ref_model
    from repro.optim import adamw as ref_adamw
    from repro_torch.pytree import leaves
    cfg, rcfg = get_config(arch), _ref_cfg(arch)
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = model_lib.abstract_params(cfg, dt, device=CPU)
        want = ref_model.abstract_params(rcfg, rdt)
        assert [(tuple(t.shape), _dt(t.dtype)) for t in leaves(got)] == \
            [(tuple(t.shape), str(t.dtype)) for t in _flat(want)]
        assert all(ca.is_fake(t) for t in leaves(got))
    state = adamw.abstract_state(got, torch.bfloat16)
    rstate = ref_adamw.abstract_state(want, jnp.bfloat16)
    assert _dt(state.step.dtype) == str(rstate.step.dtype)
    for mine, ref in ((state.params, rstate.params), (state.m, rstate.m),
                      (state.v, rstate.v)):
        assert [(tuple(t.shape), _dt(t.dtype)) for t in leaves(mine)] == \
            [(tuple(t.shape), str(t.dtype)) for t in _flat(ref)]
    assert all(t.requires_grad for t in leaves(state.params))


def test_missing_knob_and_unsupported_shape_are_skipped():
    rec = dryrun.dryrun_cell("zamba2-2.7b", "decode_32k",
                             variant="tp_decode_bf16")
    assert rec["status"] == "skipped" and "item 59" in rec["reason"]
    rec = dryrun.dryrun_cell("granite-moe-1b-a400m", "long_500k")
    assert rec["status"] == "skipped" and "500k" in rec["reason"]


# -- the serving layout (``tp_decode_bf16``) ---------------------------------

TP_ARCHS = ("gemma2-2b", "gemma3-12b", "nemotron-4-340b", "minicpm3-4b",
            "granite-moe-1b-a400m", "deepseek-v2-236b")
#: a rank's parameters under the serving layout, in billions: the MLA and
#: MoE configs at the meshes their decode cells run on
RANK_PARAMS_B = {("deepseek-v2-236b", "data16xmodel16"): 15.388,
                 ("minicpm3-4b", "data1xmodel2"): 2.215,
                 ("granite-moe-1b-a400m", "data1xmodel2"): 0.693}


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a not in TP_ARCHS])
def test_tp_variant_is_skipped_outside_the_dense_gqa_slice(arch):
    rec = dryrun.dryrun_cell(arch, "prefill_32k", variant="tp_decode_bf16")
    item = 59 if arch in ("zamba2-2.7b", "xlstm-350m") else 60
    assert rec["status"] == "skipped"
    assert f"ROADMAP item {item}" in rec["reason"]


def test_tp_variant_does_not_train():
    rec = dryrun.dryrun_cell("gemma2-2b", "train_4k",
                             variant="tp_decode_bf16")
    assert rec["status"] == "skipped" and "item 61" in rec["reason"]


def _block_bytes(cfg, mesh_shape, dtype_bytes=2):
    """Allocator bytes of one rank's serving blocks (rank 0; every rank's
    blocks have the same shapes), the full and blocks' element counts of
    the leaves that the layout splits, and the blocks' element count."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models.common import is_desc
    from repro_torch.pytree import leaves
    names = tuple(mesh_shape)
    mesh = LMMesh(names, mesh_shape, range(int(np.prod(list(
        mesh_shape.values())))), dict.fromkeys(names, 0), {})
    total, split_full, split_local, numel = 0, 0, 0, 0
    for d, s in zip(leaves(model_lib.param_descs(cfg), is_leaf=is_desc),
                    leaves(sh.named(mesh, sh.serving_pspecs(
                        cfg, mesh_shape)), is_leaf=sh.is_sharding)):
        local = int(np.prod(s.local_shape(d.shape)))
        total += ca.alloc_bytes(local * dtype_bytes)
        numel += local
        if local < int(np.prod(d.shape)):
            split_full += int(np.prod(d.shape))
            split_local += local
    return total, split_full, split_local, numel


@pytest.mark.parametrize("arch, mesh_shape", [
    ("gemma2-2b", {"data": 1, "model": 2}),
    ("gemma2-2b", None), ("gemma3-12b", None), ("nemotron-4-340b", None),
    ("deepseek-v2-236b", None), ("minicpm3-4b", {"data": 1, "model": 2}),
    ("granite-moe-1b-a400m", {"data": 1, "model": 2})])
def test_tp_decode_cell_holds_a_ranks_blocks(arch, mesh_shape):
    """``tp_decode_bf16`` at decode_32k on a fake (data 1, model 2) world
    and on the production (data 16, model 16) mesh: ok, its resident
    parameter bytes the sum of the rank's bf16 blocks (the split leaves
    at 1 / |model|; the MLA and MoE configs' blocks ``RANK_PARAMS_B``),
    the collectives equal to the tallies."""
    rec = dryrun.run_cell(arch=arch, shape_name="decode_32k",
                          variant="tp_decode_bf16", mesh_shape=mesh_shape,
                          device=CPU)
    assert rec["status"] == "ok", rec.get("traceback")
    shape = mesh_shape or {"data": 16, "model": 16}
    want, split_full, split_local, numel = _block_bytes(get_config(arch),
                                                        shape)
    assert rec["memory"]["param_bytes"] == want
    key = (arch, "x".join(f"{a}{n}" for a, n in shape.items()))
    if key in RANK_PARAMS_B:
        assert round(numel / 1e9, 3) == RANK_PARAMS_B[key]
    assert split_local * shape["model"] == split_full
    assert rec["memory"]["resident_bytes"] > want
    assert rec["collectives"]["match_tallies"]
    assert rec["collectives"]["counts"]["all-reduce"] >= \
        get_config(arch).num_layers


# -- a reduced cell on a fake world against a real two-rank step -------------

_B, _S = 4, 16


def _cfg():
    return get_config("gemma2-2b").reduced()


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T_
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = _cfg()
        mesh = M.lm_mesh({"data": 2, "model": 1})
        params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
        specs = adamw.state_pspecs(model_lib.param_pspecs(cfg, mesh.shape))
        params = T_.local_params(params, sh.named(mesh, specs).params)
        state = adamw.init_state(params)
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                 (_B, _S + 1))
        batch = {"tokens": torch.as_tensor(toks[:, :-1]),
                 "labels": torch.as_tensor(toks[:, 1:])}
        step = steps.make_train_step(cfg, mesh=mesh, remat="none",
                                     compute_dtype=torch.float32)
        sh.reset_collective_counts()
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        out = {"counts": sh.collective_counts(),
               "flops": fc.get_total_flops()}
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_reduced_cell_matches_a_gloo_step(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, 2, str(tmp_path / "rendezvous"),
                               str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    rec = dryrun.run_cell(arch="gemma2-2b", cfg=_cfg(),
                          shape_name="train_4k",
                          mesh_shape={"data": 2, "model": 1}, batch=_B,
                          seq=_S, remat="none", compute_dtype=torch.float32,
                          device=CPU)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=JOIN_TIMEOUT_S)
    try:
        for p in procs:
            p.join(max((deadline - datetime.datetime.now()).total_seconds(),
                       0.0))
        assert not any(p.is_alive() for p in procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert [p.exitcode for p in procs] == [0, 0]
    with open(tmp_path / "rank0.pkl", "rb") as f:
        real = pickle.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_ranks"] == 2
    counted = {ca.TALLY_OF_KIND[k]: v
               for k, v in rec["collectives"]["counts"].items()}
    assert counted == {k: v for k, v in real["counts"].items() if v}
    assert rec["collectives"]["match_tallies"]
    assert rec["registry_flops"] == real["flops"]
    assert rec["roofline"]["flops"] >= real["flops"]
    assert rec["memory"]["peak_bytes"] > rec["memory"]["resident_gb"] * 1e9


def test_cli_skips_and_writes_under_out(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "long_500k", "--out", str(out)]) == 0
    assert "SKIP" in capsys.readouterr().out
    import json
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "skipped"


def test_run_cell_takes_another_mesh():
    """``run_cell(mesh_shape={"data": 1, "model": 2})`` runs the cell on
    that mesh: the record carries its name (a family outside
    tensor-parallel serving skips)."""
    rec = dryrun.run_cell(arch="zamba2-2.7b", shape_name="decode_32k",
                          variant="tp_decode_bf16",
                          mesh_shape={"data": 1, "model": 2}, device=CPU)
    assert rec["mesh"] == "data1xmodel2" and rec["status"] == "skipped"
    assert "item 59" in rec["reason"]
