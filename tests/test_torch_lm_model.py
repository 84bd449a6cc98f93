"""The port's LM decoders (``repro_torch.models``: dense, MLA, MoE, Mamba2
with shared attention, xLSTM; the enc-dec and vision families only build
here) against
the live JAX reference (``repro.models``) on the same inputs, weights carried
across by ``repro_torch.convert.lm_params``.

Everything is float32 on both sides (the reference's model code casts
explicitly, so the suite's x64 mode changes only its loss accumulators).
Tolerances:

* ``rms_norm`` / ``rope`` / ``softcap`` / ``activation``: 1e-6 absolute
  plus 1e-6 relative (one ulp of the softcap's values near 30 is 1.9e-6).
* ``sdpa``: blocked against einsum and both against the reference's einsum
  at 2e-4, the reference's own bar (``tests/test_models.py``).
* ``forward_train``: the loss (and the MoE's aux) within 1e-5 relative,
  the logits within 1e-4 absolute, for reduced ``gemma2-2b``,
  ``gemma3-12b``, ``nemotron-4-340b``, ``minicpm3-4b`` (MLA),
  ``granite-moe-1b-a400m`` (MoE), ``deepseek-v2-236b`` (MLA, MoE with
  shared experts, a dense prologue layer), ``zamba2-2.7b`` (Mamba2 and the
  shared attention blocks) and ``xlstm-350m`` (mLSTM, sLSTM).  The
  logits of ``xlstm-350m`` within 1e-4 of max|logits| instead: its
  exponential gates amplify float32 rounding, and the reference's logits
  lie 1.4e-4 from a float64 evaluation of the same model at max|logits|
  4.5, the port's 4.7e-5 (``tests/test_torch_lm_ssm_xlstm.py::
  test_xlstm_float32_error_is_the_references``).
* Gradients: each leaf within 1e-4 relative L2.
* Decode against the full forward, past the local window (the ring wraps):
  2e-2 as in the reference's test, and within 1e-4 of the reference's full
  forward.  The MLA and MoE configs: decode (absorbed MLA, lossless MoE
  dispatch) within 1e-4 of the full forward at ``capacity_factor=None``,
  the port's and the reference's; ``zamba2-2.7b`` and ``xlstm-350m``
  through their recurrent caches, ``xlstm-350m`` within 1e-4 of
  max|logits| (as above).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import get_config as tget, list_archs
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.pytree import flatten, leaves

DENSE = ["gemma2-2b", "gemma3-12b", "nemotron-4-340b"]
MLA_MOE = ["minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-236b"]
RECURRENT = ["zamba2-2.7b", "xlstm-350m"]
PORTED = DENSE + MLA_MOE + RECURRENT
F32 = jnp.float32


def _pair(arch, seed=0):
    """(reference cfg, port cfg, reference params, port params): the
    reference's init, carried across."""
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


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["rms_norm", "rope", "softcap", "silu_glu",
                                "gelu_glu", "squared_relu", "gelu"])
def test_ops_match_reference(op):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32) * 3
    g = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    if op == "rms_norm":
        gamma = rng.standard_normal(16).astype(np.float32) * 0.1
        want = JC.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-6)
        got = TC.rms_norm(torch.as_tensor(x), torch.as_tensor(gamma), 1e-6)
    elif op == "rope":
        pos = np.arange(7)
        want = JC.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
        got = TC.rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0)
    elif op == "softcap":
        want = JC.softcap(jnp.asarray(x * 20), 30.0)
        got = TC.softcap(torch.as_tensor(x * 20), 30.0)
    else:
        want = JC.activation(op, jnp.asarray(x), jnp.asarray(g))
        got = TC.activation(op, torch.as_tensor(x), torch.as_tensor(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("window", [None, 700])
def test_sdpa_blocked_matches_einsum(window):
    rng = np.random.default_rng(0)
    B, S, H, KV, dh = 2, 2048, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, KV, KV))
    pos = np.arange(S)
    want = np.asarray(JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(pos),
                              window=window, force_impl="einsum"))
    args = [torch.as_tensor(a) for a in (q, k, v, pos, pos)]
    with torch.no_grad():
        out_e = TA.sdpa(*args, window=window, force_impl="einsum")
        out_b = TA.sdpa(*args, window=window, force_impl="blocked")
    np.testing.assert_allclose(_np(out_b), _np(out_e), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(out_e), want, rtol=2e-4, atol=2e-4)


def test_gqa_maps_query_head_to_kv_head_by_block():
    """Query head h reads KV head h // rep: zeroing KV head 0's values
    zeroes query heads 0 .. rep - 1 only."""
    rng = np.random.default_rng(2)
    B, S, H, KV, dh = 1, 5, 6, 2, 4
    q = torch.as_tensor(rng.standard_normal((B, S, H, dh)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32)
    v[:, :, 0] = 0
    pos = torch.arange(S)
    out = TA.sdpa(q, k, v, pos, pos)
    assert float(out[:, :, :3].abs().max()) == 0.0
    assert float(out[:, :, 3:].abs().min()) > 0.0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_param_tree_matches_reference(arch):
    """Leaf paths, order and shapes of the reference's tree; the counts at
    full width; the init rule (fan-in over the stack axis, 1-D zeros)."""
    jc, tc = jget(arch), tget(arch)
    assert TM.param_count(tc) == JM.param_count(jc)
    jd = JM.param_descs(jc.reduced())
    ref_paths = ["/".join(str(k.key) for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(
                     jd, is_leaf=JC.is_desc)[0]]
    gen = torch.Generator().manual_seed(0)
    tp = TM.init_params(tc.reduced(), gen)
    named = dict(tp.named_parameters())
    leaves_t = leaves(tp)
    assert [n.replace(".", "/") for n in named] != [] and \
        sorted(n.replace(".", "/") for n in named) == sorted(ref_paths)
    for path, leaf in zip(ref_paths, leaves_t):
        assert leaf is named[path.replace("/", ".")]
    for path, desc in zip(ref_paths, jax.tree.leaves(jd, is_leaf=JC.is_desc)):
        w = named[path.replace("/", ".")]
        assert tuple(w.shape) == desc.shape and w.dtype == torch.float32
        if desc.scale == 0.0:                  # norms: 0, stacked or not
            assert float(w.detach().abs().max()) == 0.0
        else:
            std = desc.scale / np.sqrt(np.prod(desc.shape[:-1]))
            # 0.1, or three standard errors of a sample std where that is
            # more (under 450 draws: zamba2's (1, 8) ``d_skip``)
            tol = max(0.1, 3 / np.sqrt(2 * w.numel()))
            assert abs(float(w.detach().std()) / std - 1) < tol


def test_init_draws_from_the_generator_device():
    tc = tget("gemma2-2b").reduced()
    a = TM.init_params(tc, torch.Generator().manual_seed(3))
    b = TM.init_params(tc, torch.Generator().manual_seed(3))
    c = TM.init_params(tc, torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(leaves(a)[0], leaves(c)[0])


@pytest.mark.parametrize("arch", PORTED)
def test_cache_shapes_match_reference(arch):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    want = [tuple(s.shape) for s in
            jax.tree.leaves(JM.cache_shapes(jc, 3, 40, F32))]
    got = [tuple(t.shape) for t in
           leaves(TM.init_cache(tc, 3, 40, torch.float32, device="cpu"))]
    assert got == want


# ---------------------------------------------------------------------------
# forward, gradients, decode
# ---------------------------------------------------------------------------

def _logits_tol(arch, logits):
    """1e-4, or 1e-4 of max|logits| for xLSTM (see the module's note)."""
    scale = float(np.abs(logits).max()) if arch == "xlstm-350m" else 1.0
    return 1e-4 * scale


def _ref_logits(jp, jc, tokens, capacity_factor=1.25):
    x = JM.embed_tokens(jp, jc, tokens, F32)
    x, _, _ = JM.decoder_stack(jp, x, jnp.arange(x.shape[1]), jc,
                               remat="none", capacity_factor=capacity_factor)
    return np.asarray(JM.logits_fn(jp, jc, JM.rms_norm(
        x, jp["final_norm"], jc.norm_eps)))


def _port_logits(tp, tc, tokens, capacity_factor=1.25):
    with torch.no_grad():
        x = TM.embed_tokens(tp, tc, tokens, torch.float32)
        x, _, _ = TM.decoder_stack(tp, x, torch.arange(x.shape[1]), tc,
                                   remat="none",
                                   capacity_factor=capacity_factor)
        return _np(TM.logits_fn(tp, tc, TM.rms_norm(
            x, tp["final_norm"], tc.norm_eps)))


@pytest.mark.parametrize("arch", PORTED)
def test_forward_train_matches_reference(arch):
    jc, tc, jp, tp = _pair(arch)
    jb, tb = _tokens(jc, 2, 64)
    want, jm = JM.forward_train(jp, jc, jb, remat="none", compute_dtype=F32)
    with torch.no_grad():
        got, metrics = TM.forward_train(tp, tc, tb, remat="full",
                                        compute_dtype=torch.float32)
    assert abs(float(got) / float(want) - 1) < 1e-5
    if tc.num_experts:
        assert float(metrics["aux"]) > 0
        assert abs(float(metrics["aux"]) / float(jm["aux"]) - 1) < 1e-5
    else:
        assert float(metrics["aux"]) == 0.0
    ref = _ref_logits(jp, jc, jb["tokens"])
    np.testing.assert_allclose(_port_logits(tp, tc, tb["tokens"]), ref,
                               rtol=0, atol=_logits_tol(arch, ref))


def test_gradients_match_reference():
    jc, tc, jp, tp = _pair("gemma2-2b", seed=1)
    jb, tb = _tokens(jc, 2, 64, seed=1)
    jg = jax.grad(lambda p: JM.forward_train(
        p, jc, jb, remat="none", compute_dtype=F32)[0])(jp)
    loss, _ = TM.forward_train(tp, tc, tb, remat="none",
                               compute_dtype=torch.float32)
    tg = torch.autograd.grad(loss, leaves(tp))
    for want, got in zip(jax.tree.leaves(jg), tg):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(_np(got) - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert err < 1e-4


@pytest.mark.parametrize("remat", ["full", "nothing", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    _, tc, _, tp = _pair("gemma3-12b")
    _, tb = _tokens(tc, 2, 32)
    base = torch.autograd.grad(TM.forward_train(
        tp, tc, tb, remat="none", compute_dtype=torch.float32)[0],
        leaves(tp))
    got = torch.autograd.grad(TM.forward_train(
        tp, tc, tb, remat=remat, compute_dtype=torch.float32)[0], leaves(tp))
    for a, b in zip(base, got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_decode_matches_full_forward_past_the_window():
    """T = 48 past the reduced window 32 with a 64-slot cache: the local
    layers' 32-slot ring wraps."""
    jc, tc, jp, tp = _pair("gemma2-2b")
    assert tc.window_size == 32
    B, T = 2, 48
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (B, T))
    full = _port_logits(tp, tc, torch.as_tensor(toks))
    ref = _ref_logits(jp, jc, jnp.asarray(toks, jnp.int32))
    caches = TM.init_cache(tc, B, 64, torch.float32, device="cpu")
    assert caches["blocks"]["l0"].k.shape[2] == 32       # the local ring
    errs, errs_ref = [], []
    with torch.no_grad():
        for t in range(T):
            logits, caches = TM.forward_decode(
                tp, tc, caches, torch.as_tensor(toks[:, t:t + 1]), t,
                compute_dtype=torch.float32)
            errs.append(np.abs(_np(logits[:, 0]) - full[:, t]).max())
            errs_ref.append(np.abs(_np(logits[:, 0]) - ref[:, t]).max())
    assert max(errs) < 2e-2 and max(errs_ref) < 1e-4


@pytest.mark.parametrize("arch", MLA_MOE + RECURRENT)
def test_decode_matches_full_forward_lossless(arch):
    """The reference's ``tests/test_models.py`` decode case: T 48 steps into
    a 64-slot cache against the full forward at ``capacity_factor=None``
    (MLA decodes in the absorbed form, MoE dispatches losslessly; Mamba2,
    the shared blocks and xLSTM through their caches), within 1e-4 (xLSTM:
    1e-4 of max|logits|) of the port's and of the reference's full
    forward."""
    jc, tc, jp, tp = _pair(arch)
    B, T = 2, 48
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (B, T))
    full = _port_logits(tp, tc, torch.as_tensor(toks), capacity_factor=None)
    ref = _ref_logits(jp, jc, jnp.asarray(toks, jnp.int32),
                      capacity_factor=None)
    tol = _logits_tol(arch, ref)
    np.testing.assert_allclose(full, ref, rtol=0, atol=tol)
    caches = TM.init_cache(tc, B, 64, torch.float32, device="cpu")
    errs = []
    with torch.no_grad():
        for t in range(T):
            logits, caches = TM.forward_decode(
                tp, tc, caches, torch.as_tensor(toks[:, t:t + 1]), t,
                compute_dtype=torch.float32)
            errs.append(max(np.abs(_np(logits[:, 0]) - full[:, t]).max(),
                            np.abs(_np(logits[:, 0]) - ref[:, t]).max()))
    assert max(errs) < tol


def test_prefill_and_serve_steps():
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    _, tc, _, tp = _pair("nemotron-4-340b")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab_size, (2, 9)))
    last = make_prefill_step(tc, compute_dtype=torch.float32)(
        tp, {"tokens": toks})
    np.testing.assert_allclose(_np(last[:, 0]),
                               _port_logits(tp, tc, toks)[:, -1], atol=1e-5)
    step = make_serve_step(tc, compute_dtype=torch.float32)
    caches = TM.init_cache(tc, 2, 16, torch.float32, device="cpu")
    for t in range(9):
        nxt, caches = step(tp, caches, toks[:, t:t + 1], t)
    assert torch.equal(nxt[:, 0], last[:, 0].argmax(-1))


# ---------------------------------------------------------------------------
# the registry, the enc-dec and vision families, refusals
# ---------------------------------------------------------------------------

# their forward, decode and gradients: tests/test_torch_lm_encdec_vision.py
ENCDEC_VISION = ["seamless-m4t-medium", "llava-next-mistral-7b"]


def test_registry_holds_the_ten_configs():
    assert sorted(list_archs()) == sorted(PORTED + ENCDEC_VISION)
    for name in list_archs():
        assert dataclasses.asdict(tget(name)) == dataclasses.asdict(
            jget(name))


@pytest.mark.parametrize("arch", ENCDEC_VISION)
def test_encdec_and_vision_families_build_the_references_tree(arch):
    """The reduced config builds: the parameters in the reference's leaf
    order with its paths and shapes, the decode cache with its leaf
    shapes and dtypes."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(0), F32)
    tp = TM.init_params(tc, torch.Generator().manual_seed(0))
    ref_paths = ["/".join(str(k.key) for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
    named = dict(tp.named_parameters())
    assert sorted(n.replace(".", "/") for n in named) == sorted(ref_paths)
    for path, leaf, want in zip(ref_paths, leaves(tp), jax.tree.leaves(jp)):
        assert leaf is named[path.replace("/", ".")]
        assert tuple(leaf.shape) == want.shape
    want = jax.tree.leaves(JM.init_cache(jc, 2, 8, F32))
    got = leaves(TM.init_cache(tc, 2, 8, torch.float32, device="cpu"))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float32 for g in got)


def test_mesh_seq_shard_and_unknown_remat_refuse():
    """Under a mesh of one (``make_local_mesh()`` with no process group),
    ``forward_train`` with and without ``seq_shard`` equals ``mesh=None``
    bit for bit, loss and gradients; an object that is not an ``LMMesh``
    raises ``TypeError``; an unknown remat policy ``ValueError``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    _, tc, _, tp = _pair("gemma2-2b")
    _, tb = _tokens(tc, 2, 8)
    mesh = make_local_mesh()
    assert mesh.size == 1

    def run(**kw):
        loss, m = TM.forward_train(tp, tc, tb, compute_dtype=torch.float32,
                                   **kw)
        return [loss, m["ce"], m["aux"]] + list(
            torch.autograd.grad(loss, leaves(tp)))

    want = run()
    for kw in ({"mesh": mesh}, {"mesh": mesh, "seq_shard": True}):
        for a, b in zip(run(**kw), want):
            assert torch.equal(a, b), kw
    with pytest.raises(TypeError, match="LMMesh"):
        TM.forward_train(tp, tc, tb, mesh=object())
    with pytest.raises(TypeError, match="LMMesh"):
        make_train_step(tc, mesh=object(), seq_shard=True)
    with pytest.raises(ValueError, match="remat"):
        TM.forward_train(tp, tc, tb, remat="offload")


def test_flatten_order_is_the_references():
    tree = {"b": {"y": 1, "x": [2, None, 3]}, "a": (4, {"k": 5}), "c": None}
    got, td = flatten(tree)
    assert got == jax.tree.leaves(tree)
    assert got == [4, 5, 2, 3, 1]
    assert repr(td) == ("dict{'a': tuple(*, dict{'k': *}), 'b': dict{'x': "
                        "list(*, None, *), 'y': *}, 'c': None}")
