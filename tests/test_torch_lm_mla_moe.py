"""MLA attention and the MoE FFN of the port (``repro_torch.models.attention``
``mla_*``, ``repro_torch.models.moe``) against the live JAX reference on the
same inputs: numpy draws from a seed, weights carried across by
``repro_torch.convert.lm_params``.

Everything is float32 on both sides, on ``reduced()`` configs (qk head dim
12 against v head dim 8, so a swap of the two shows).  Tolerances:

* MLA's expanded forward and the MoE layer's output: 1e-5 absolute plus
  1e-5 relative; the absorbed decode, step by step, within 1e-5 of the
  expanded forward and of the reference's absorbed decode.
* ``router_topk``: indices equal, gates 1e-6, aux 1e-6 relative.
* ``moe_ffn_local`` at a capacity that drops tokens: the dropped pairs are
  the reference's (the outputs agree where they differ from lossless
  dispatch), 1e-5.
* Models: the loss within 1e-5 relative, the logits within 1e-4, each
  gradient leaf within 1e-4 relative L2 norm; ``sgl_prox_step`` 1e-6.
* bfloat16 compute: the dtypes the reference keeps, values within 3e-2.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import get_config as jget
from repro.launch import train as jtrain
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import leaves

F32 = jnp.float32
MLA_MOE = ["minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(arch, **changes):
    return (dataclasses.replace(jget(arch).reduced(), **changes),
            dataclasses.replace(tget(arch).reduced(), **changes))


def _layer(jc, key, seed=0):
    """The first period's layer ``key`` of a reference init, unstacked, and
    its port copy."""
    jp = JM.init_params(jc, jax.random.PRNGKey(seed), F32)
    sub = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"]["l0"][key])
    return (jax.tree.map(jnp.asarray, sub),
            jax.tree.map(lambda a: torch.as_tensor(a.copy()), sub))


def _x(shape, seed=1, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x * scale), torch.as_tensor(x * scale)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_CASES = [("minicpm3-4b", {}), ("deepseek-v2-236b", {}),
             ("minicpm3-4b", {"q_lora_rank": 0}),
             ("deepseek-v2-236b", {"attn_softcap": 5.0})]


@pytest.mark.parametrize("arch,changes", MLA_CASES)
def test_mla_expanded_forward_matches_reference(arch, changes):
    jc, tc = _cfgs(arch, **changes)
    jp, tp = _layer(jc, "attn")
    jx, tx = _x((2, 24, jc.d_model))
    pos = np.arange(24)
    want, wc = JA.mla_forward(jp, jx, jnp.asarray(pos), jc)
    with torch.no_grad():
        got, gc = TA.mla_forward(tp, tx, torch.as_tensor(pos), tc)
    assert wc is None and gc is None
    assert tuple(got.shape) == (2, 24, jc.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,changes", MLA_CASES)
def test_mla_absorbed_decode_matches_expanded(arch, changes):
    """Step by step into a 32-slot latent cache: each step within 1e-5 of
    the expanded forward's row and of the reference's absorbed step; the
    cache holds the latent (B, S, kv_lora_rank) and rope (B, S, rp) rows,
    never a head axis, written in place."""
    jc, tc = _cfgs(arch, **changes)
    jp, tp = _layer(jc, "attn", seed=2)
    B, T, S = 2, 20, 32
    jx, tx = _x((B, T, jc.d_model), seed=3)
    with torch.no_grad():
        full, _ = TA.mla_forward(tp, tx, torch.arange(T), tc)
    ckv, kr = TA.mla_cache_shape(tc, B, S)
    assert ckv == (B, S, tc.kv_lora_rank) and kr == (B, S,
                                                     tc.qk_rope_head_dim)
    cache = TA.MLACache(torch.zeros(ckv), torch.zeros(kr))
    jcache = JA.MLACache(jnp.zeros(ckv, F32), jnp.zeros(kr, F32))
    for t in range(T):
        with torch.no_grad():
            got, new = TA.mla_forward(tp, tx[:, t:t + 1], torch.full((1,), t),
                                      tc, cache=cache, cache_pos=t)
        assert new.ckv is cache.ckv and new.krope is cache.krope
        want, jcache = JA.mla_forward(jp, jx[:, t:t + 1], jnp.full((1,), t),
                                      jc, cache=jcache, cache_pos=t)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]), **TOL)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(cache.ckv), np.asarray(jcache.ckv), **TOL)
    np.testing.assert_allclose(_np(cache.krope), np.asarray(jcache.krope),
                               **TOL)
    assert float(cache.ckv[:, T:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="one token"):
        TA.mla_forward(tp, tx[:, :2], torch.arange(2), tc, cache=cache,
                       cache_pos=0)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_router_topk_matches_reference():
    jc, tc = _cfgs("granite-moe-1b-a400m")
    jp, tp = _layer(jc, "ffn")
    jx, tx = _x((3, 17, jc.d_model))
    wi, wg, wa = JMoE.router_topk(jp, jx, jc)
    with torch.no_grad():
        gi, gg, ga = TMoE.router_topk(tp, tx, tc)
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))
    np.testing.assert_allclose(_np(gg), np.asarray(wg), rtol=1e-6, atol=1e-6)
    assert gg.dtype == torch.float32 and ga.dtype == torch.float32
    assert abs(float(ga) / float(wa) - 1) < 1e-6


def test_router_ties_go_to_the_lower_expert():
    """Duplicated router columns make exact ties: the reference's
    ``lax.top_k`` keeps the lower index, and so does the port."""
    jc, tc = _cfgs("granite-moe-1b-a400m")
    _, tp = _layer(jc, "ffn")
    r = _np(tp["router"]).copy()
    r[:, 5] = r[:, 2]
    r[:, 7] = r[:, 2]
    r[:, 4] = r[:, 1]
    jx, tx = _x((2, 40, jc.d_model), seed=5)
    wi, _, wa = JMoE.router_topk({"router": jnp.asarray(r)}, jx, jc)
    with torch.no_grad():
        gi, _, ga = TMoE.router_topk({"router": torch.as_tensor(r)}, tx, tc)
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))
    assert abs(float(ga) / float(wa) - 1) < 1e-6


def _moe_inputs(jc, seed=0, T=96):
    jp, tp = _layer(jc, "ffn", seed=seed)
    jx, tx = _x((T, jc.d_model), seed=seed + 1)
    idx, gw, _ = JMoE.router_topk(jp, jx[None], jc)
    k = jc.experts_per_token
    return jp, tp, jx, tx, idx.reshape(T, k), gw.reshape(T, k)


@pytest.mark.parametrize("capacity", [None, 8, 20])
def test_moe_ffn_local_matches_reference(capacity):
    """Capacity 8 and 20 drop pairs (T k / E = 24 a expert on average);
    None is every pair.  The dropped pairs are the reference's: where the
    capped output differs from the lossless one, the port's does too, and
    by the same amount."""
    jc, tc = _cfgs("granite-moe-1b-a400m")
    jp, tp, jx, tx, idx, gw = _moe_inputs(jc)
    T, k = idx.shape
    cap = T * k if capacity is None else capacity
    args = lambda p: (p["w_in"], p["w_gate"], p["w_out"])
    want = JMoE.moe_ffn_local(jx, idx, gw, *args(jp), e_lo=0,
                              n_local=jc.num_experts, capacity=cap,
                              act=jc.mlp_act)
    with torch.no_grad():
        got = TMoE.moe_ffn_local(
            tx, torch.as_tensor(np.asarray(idx)),
            torch.as_tensor(np.asarray(gw)), *args(tp), e_lo=0,
            n_local=tc.num_experts, capacity=cap, act=tc.mlp_act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    lossless = JMoE.moe_ffn_local(jx, idx, gw, *args(jp), e_lo=0,
                                  n_local=jc.num_experts, capacity=T * k,
                                  act=jc.mlp_act)
    moved = np.abs(np.asarray(want) - np.asarray(lossless)).max(axis=1) > 1e-4
    assert moved.any() == (capacity is not None)


def test_moe_ffn_local_takes_its_share_of_the_experts():
    """A shard of experts [e_lo, e_lo + n_local): pairs of other experts
    contribute nothing, as in the reference's expert-parallel body."""
    jc, tc = _cfgs("granite-moe-1b-a400m")
    jp, tp, jx, tx, idx, gw = _moe_inputs(jc, seed=3)
    sl = slice(2, 6)
    want = JMoE.moe_ffn_local(jx, idx, gw, jp["w_in"][sl], jp["w_gate"][sl],
                              jp["w_out"][sl], e_lo=2, n_local=4,
                              capacity=20, act=jc.mlp_act)
    with torch.no_grad():
        got = TMoE.moe_ffn_local(
            tx, torch.as_tensor(np.asarray(idx)),
            torch.as_tensor(np.asarray(gw)), tp["w_in"][sl],
            tp["w_gate"][sl], tp["w_out"][sl], e_lo=2, n_local=4,
            capacity=20, act=tc.mlp_act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("capacity,e_lo,n_local", [
    (None, 0, 8), (8, 0, 8), (20, 0, 8), (20, 2, 4)])
def test_log_kept_counts_each_calls_kept_pairs(capacity, e_lo, n_local):
    """``log_kept`` receives one count a ``moe_ffn_local`` call: the pairs
    of the call's experts up to each one's capacity; nothing is logged
    outside the block."""
    jc, tc = _cfgs("granite-moe-1b-a400m")
    jp, tp, jx, tx, idx, gw = _moe_inputs(jc, seed=3)
    T, k = idx.shape
    cap = T * k if capacity is None else capacity
    sl = slice(e_lo, e_lo + n_local)
    call = lambda: TMoE.moe_ffn_local(
        tx, torch.as_tensor(np.asarray(idx)),
        torch.as_tensor(np.asarray(gw)), tp["w_in"][sl], tp["w_gate"][sl],
        tp["w_out"][sl], e_lo=e_lo, n_local=n_local, capacity=cap,
        act=tc.mlp_act)
    with torch.no_grad():
        with TMoE.log_kept() as kept:
            call()
            call()
        call()
    load = np.bincount(np.asarray(idx).reshape(-1),
                       minlength=jc.num_experts)[sl]
    want = int(np.minimum(load, cap).sum())
    assert [int(c) for c in kept] == [want, want]
    assert (want < load.sum()) == (capacity is not None)


@pytest.mark.parametrize("arch,cf", [("deepseek-v2-236b", 1.25),
                                     ("deepseek-v2-236b", None),
                                     ("granite-moe-1b-a400m", 1.25)])
def test_moe_forward_matches_reference(arch, cf):
    """``moe_forward`` with deepseek's two shared experts and granite's
    none, at the default capacity and lossless; its aux."""
    jc, tc = _cfgs(arch)
    jp, tp = _layer(jc, "ffn", seed=4)
    assert ("shared_in" in tp) == bool(tc.num_shared_experts)
    jx, tx = _x((2, 40, jc.d_model), seed=6)
    want, wa = JMoE.moe_forward(jp, jx, jc, capacity_factor=cf)
    with torch.no_grad():
        got, ga = TMoE.moe_forward(tp, tx, tc, capacity_factor=cf)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert abs(float(ga) / float(wa) - 1) < 1e-6


def test_moe_capacity_is_the_references():
    """``int(ceil(T k / E * factor))`` capped at T k and at least 8, as the
    reference computes it inline."""
    for T, k, E, cf in [(1024, 8, 32, 1.25), (4, 8, 32, 1.25), (3, 2, 8, 1.25),
                        (96, 2, 8, None), (7, 6, 160, 2.0)]:
        want = T * k if cf is None else max(
            min(int(np.ceil(T * k / E * cf)), T * k), 8)
        assert TMoE.capacity_of(T, k, E, cf) == want


def test_moe_bf16_compute_keeps_the_references_dtypes():
    """bfloat16 activations with float32 weights (the reference's experts
    promote): output bfloat16, aux float32, values within 3e-2."""
    jc, tc = _cfgs("deepseek-v2-236b")
    jp, tp = _layer(jc, "ffn", seed=7)
    jx, tx = _x((2, 16, jc.d_model), seed=8)
    want, wa = JMoE.moe_forward(jp, jx.astype(jnp.bfloat16), jc)
    with torch.no_grad():
        got, ga = TMoE.moe_forward(tp, tx.to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16 and ga.dtype == torch.float32
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(F32)), atol=3e-2)


def test_moe_under_a_mesh_refuses():
    """``moe_forward`` under a mesh of one equals ``mesh=None`` bit for
    bit (output, aux and gradients, at capacity 1.25 and lossless); an
    object that is not an ``LMMesh`` raises ``TypeError``."""
    from repro_torch.launch.mesh import make_local_mesh
    _, tc = _cfgs("granite-moe-1b-a400m")
    _, tp = _layer(jget("granite-moe-1b-a400m").reduced(), "ffn")
    _, tx = _x((2, 8, tc.d_model))
    params = {k: v.requires_grad_() for k, v in tp.items()}
    mesh = make_local_mesh()
    for cf in (1.25, None):
        got = []
        for m in (None, mesh):
            out, aux = TMoE.moe_forward(params, tx, tc, mesh=m,
                                        capacity_factor=cf)
            grads = torch.autograd.grad((out ** 2).sum() + aux,
                                        list(params.values()))
            got.append([out, aux, *grads])
        for a, b in zip(*got):
            assert torch.equal(a, b), cf
    with pytest.raises(TypeError, match="LMMesh"):
        TMoE.moe_forward(tp, tx, tc, mesh=object())


# ---------------------------------------------------------------------------
# the three models: gradients, remat, the prox, checkpoints, the CLIs
# ---------------------------------------------------------------------------

def _pair(arch, seed=0):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(seed), F32)
    return jc, tc, jp, convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


@pytest.mark.parametrize("arch", MLA_MOE)
def test_gradients_match_reference(arch):
    """Every leaf, the prologue's and the router's among them, within 1e-4
    relative L2 of the reference's (capacity 1.25: tokens dropped alike)."""
    jc, tc, jp, tp = _pair(arch, seed=1)
    jb, tb = _tokens(jc, 2, 32, seed=1)
    jg = jax.grad(lambda p: JM.forward_train(
        p, jc, jb, remat="none", compute_dtype=F32)[0])(jp)
    loss, _ = TM.forward_train(tp, tc, tb, remat="none",
                               compute_dtype=torch.float32)
    tg = torch.autograd.grad(loss, leaves(tp))
    assert len(tg) == len(jax.tree.leaves(jg))
    for want, got in zip(jax.tree.leaves(jg), tg):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(_np(got) - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert err < 1e-4


def test_remat_recomputes_the_same_routing():
    """Under ``remat='full'`` the backward reruns the router: the gradients
    equal the unrematerialised ones."""
    _, tc, _, tp = _pair("deepseek-v2-236b", seed=2)
    _, tb = _tokens(tc, 2, 32, seed=2)
    grads = [torch.autograd.grad(TM.forward_train(
        tp, tc, tb, remat=r, compute_dtype=torch.float32)[0], leaves(tp))
        for r in ("none", "full")]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", MLA_MOE)
def test_sgl_prox_step_matches_reference(arch):
    """The head groups of MLA's ``attn/wk_b`` (axis 2 of the stacked leaf)
    and the expert groups of ``ffn/w_in`` (axis 1), as the reference
    resolves them; the prologue is left alone."""
    jc, tc, jp, tp = _pair(arch, seed=4)
    want = jtrain.sgl_prox_step(jp, jc, 2e-2, 1e-2)
    got = ttrain.sgl_prox_step(tp, tc, 2e-2, 1e-2)
    assert got is tp
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
    l0 = got["blocks"]["l0"]
    key = "wk_b" if tc.mla else "wq"
    assert float((l0["attn"][key] == 0).sum()) > 0
    if tc.num_experts:
        w_in = l0["ffn"]["w_in"]
        assert ttrain._resolve_group_axis(tuple(w_in.shape),
                                          tc.num_experts, 1) == 1


def test_checkpoint_reference_writes_port_restores_deepseek(tmp_path):
    """deepseek-v2's reduced train state (a ``pro0`` layer, MLA and MoE
    leaves) written by the reference, restored by the port bit for bit, and
    back."""
    jc = jget("deepseek-v2-236b").reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(5), F32)
    rng = np.random.default_rng(5)
    fill = lambda t: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), F32), t)
    js = jadamw.TrainState(jnp.asarray(7, jnp.int32), jp, fill(jp), fill(jp))
    path = str(tmp_path / "ck")
    jckpt.save(path, 7, js)
    like = tadamw.init_state(TM.init_params(
        tget("deepseek-v2-236b").reduced(), torch.Generator().manual_seed(9)))
    got, _ = tckpt.restore(path, 7, like)
    assert "pro0" in got.params and int(got.step) == 7
    for g, w in zip(leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    tckpt.save(path, 8, got)
    back, _ = jckpt.restore(path, 8, js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mla_cache_flattens_in_the_references_order():
    """The decode cache of deepseek-v2 (a prologue list, stacked
    ``MLACache`` leaves) flattens leaf for leaf as the reference's."""
    jc, tc = jget("deepseek-v2-236b").reduced(), tget(
        "deepseek-v2-236b").reduced()
    want = JM.init_cache(jc, 2, 16, F32)
    got = TM.init_cache(tc, 2, 16, torch.float32, device="cpu")
    assert isinstance(got["prologue"][0], TA.MLACache)
    assert [tuple(t.shape) for t in leaves(got)] == \
        [tuple(a.shape) for a in jax.tree.leaves(want)]


def test_train_and_serve_clis_on_the_new_families(capsys):
    """``train.main`` on reduced granite-moe with the prox (the per-step
    aux reported), ``serve.main`` on reduced minicpm3, the prefill step on
    deepseek-v2 at the default capacity, and the example's channel signal
    of an MoE ``w_in`` (R, E, d, f): one value a channel, ``moe_d_ff``."""
    from repro_torch.examples.sgl_pruned_lm import ffn_channel_signal
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.steps import make_prefill_step
    metrics = []
    losses, state = ttrain.main(
        ["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "3",
         "--global-batch", "2", "--seq", "32", "--lr", "1e-2",
         "--sgl-lambda", "3e-2", "--device", "cpu"], return_state=True,
        step_metrics=metrics)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [m["loss"] for m in metrics] == losses
    assert all(m["aux"] > 0 for m in metrics)
    tc = tget("granite-moe-1b-a400m").reduced()
    assert ffn_channel_signal(state.params).shape == (tc.moe_d_ff,)
    gen = tserve.main(["--arch", "minicpm3-4b", "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--cache-len",
                       "16", "--device", "cpu"])
    assert gen.shape == (2, 6)
    _, tc, _, tp = _pair("deepseek-v2-236b")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab_size, (2, 9)))
    last = make_prefill_step(tc, compute_dtype=torch.float32)(
        tp, {"tokens": toks})
    with torch.no_grad():
        x = TM.embed_tokens(tp, tc, toks, torch.float32)
        x, _, _ = TM.decoder_stack(tp, x, torch.arange(9), tc, remat="none")
        full = TM.logits_fn(tp, tc, TM.rms_norm(x, tp["final_norm"],
                                                tc.norm_eps))
    torch.testing.assert_close(last[:, 0], full[:, -1], rtol=0, atol=1e-5)
