"""The enc-dec family (``seamless-m4t-medium``: an encoder over precomputed
frames, a decoder with cross-attention) and the vision prefix
(``llava-next-mistral-7b``: precomputed patches before the tokens, masked
out of the loss) of the port against the live JAX reference on the same
inputs: numpy draws from a seed, weights carried across by
``repro_torch.convert.lm_params``.

Everything is float32 on both sides, on ``reduced()`` configs (seamless:
2 + 2 layers, d 64, 4 heads of 16, 2 KV heads, vocabulary 256; llava: one
layer, 16 patches), remat none on the reference's side.  Tolerances:

* The loss within 1e-5 relative; each gradient leaf within 1e-4 relative
  L2.
* ``encdec_forward``'s ``y`` and ``enc_out`` and ``_cross_attention``
  within 1e-5 absolute plus relative.
* Enc-dec decode within 1e-4 of max|logits| of the port's full forward,
  and within 1e-4 of the reference's decode.
* The vision loss within 1e-5 relative of a cross-entropy by hand over
  the text positions.
* Microbatched updates within 1e-5 of the full batch's, the losses within
  1e-4 (the bars of ``tests/test_system.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import get_config as jget
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import common as JC
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import flatten, leaves

F32 = jnp.float32
SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-mistral-7b"
ARCHS = [SEAMLESS, LLAVA]
FULL_COUNT = {SEAMLESS: 877_094_912, LLAVA: 7_241_732_096}
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(_np(got) - want) / max(np.linalg.norm(want), 1e-30)


def _pair(arch, seed=0):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(seed), F32)
    return jc, tc, jp, convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B, S, seed=0, n_extra=None):
    """tokens and labels (B, S), and seamless's frames (B, n_extra or S, d)
    or llava's patches (B, num_patches, d): (reference batch, port
    batch)."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "encdec":
        arrs["frames"] = rng.standard_normal(
            (B, n_extra or S, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        arrs["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else F32)
          for k, v in arrs.items()}
    return jb, {k: torch.as_tensor(v) for k, v in arrs.items()}


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_descriptors_match_reference(arch):
    """At the published width, from the descriptors alone (nothing is
    allocated): the reference's leaf paths in its order, shapes, axes,
    scales and dtypes, and its parameter count."""
    jd = JM.param_descs(jget(arch))
    td = TM.param_descs(tget(arch))
    want = jax.tree_util.tree_flatten_with_path(jd, is_leaf=JC.is_desc)[0]
    got, _ = flatten(td)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert (g.shape, g.axes, g.scale, g.dtype) == \
            (w.shape, w.axes, w.scale, w.dtype), path
    assert TM.param_count(tget(arch)) == JM.param_count(jget(arch)) == \
        FULL_COUNT[arch]
    if arch == SEAMLESS:
        assert td["encoder"]["attn"]["wq"].shape[0] == 12
        assert td["decoder"]["xattn"]["wo"].shape[0] == 12
        assert "blocks" not in td and "lm_head" in td


def test_encdec_cache_has_the_references_structure():
    """``{"decoder": {"self": KVCache}, "enc_out"}``: the leaf order,
    shapes and dtypes of the reference's ``cache_shapes``, the KV rows
    stacked over ``dec_layers``, ``enc_out`` as long as the cache."""
    jc, tc = jget(SEAMLESS).reduced(), tget(SEAMLESS).reduced()
    want = JM.cache_shapes(jc, 3, 24, jnp.bfloat16)
    got = TM.cache_shapes(tc, 3, 24, torch.bfloat16)
    assert sorted(got) == sorted(want) == ["decoder", "enc_out"]
    assert list(got["decoder"]) == ["self"]
    assert type(got["decoder"]["self"]).__name__ == \
        type(want["decoder"]["self"]).__name__ == "KVCache"
    g, _ = flatten(got)
    w = jax.tree.leaves(want)
    assert [s.shape for s in g] == [s.shape for s in w]
    assert all(s.dtype == torch.bfloat16 for s in g)
    assert got["enc_out"].shape == (3, 24, tc.d_model)
    assert got["decoder"]["self"].k.shape[0] == tc.dec_layers


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,S", [(SEAMLESS, 32), (LLAVA, 48)])
def test_loss_and_gradients_match_reference(arch, S):
    """seamless at B 2 with 32 frames and 32 tokens (the port's layer
    bodies under a non-reentrant checkpoint, ``remat="full"``); llava at
    B 2 with its 16 patches and 48 tokens (total 64)."""
    jc, tc, jp, tp = _pair(arch, seed=1)
    jb, tb = _batch(jc, 2, S, seed=1)
    (want, jm), jg = jax.jit(jax.value_and_grad(lambda p: JM.forward_train(
        p, jc, jb, remat="none", compute_dtype=F32), has_aux=True))(jp)
    loss, metrics = TM.forward_train(tp, tc, tb, remat="full",
                                     compute_dtype=torch.float32)
    assert sorted(metrics) == sorted(jm)
    assert abs(float(loss) / float(want) - 1) < 1e-5
    tg = torch.autograd.grad(loss, leaves(tp))
    assert len(tg) == len(jax.tree.leaves(jg))
    for w, g in zip(jax.tree.leaves(jg), tg):
        assert _rel(g, w) < 1e-4
    if arch == SEAMLESS:
        # every encoder and decoder layer, and cross-attention, is trained
        index = {id(t): i for i, t in enumerate(leaves(tp))}
        named = {n: tg[index[id(t)]] for n, t in tp.named_parameters()}
        for key in ("encoder.attn.wq", "decoder.xattn.wk",
                    "decoder.ffn.w_in"):
            assert all(float(named[key][r].abs().max()) > 0
                       for r in range(2))


# ---------------------------------------------------------------------------
# enc-dec internals and decode
# ---------------------------------------------------------------------------

def test_encdec_forward_and_cross_attention_match_reference():
    jc, tc, jp, tp = _pair(SEAMLESS, seed=2)
    jb, tb = _batch(jc, 2, 24, seed=2, n_extra=40)
    jy, jenc, jcache = JM.encdec_forward(jp, jc, jb["frames"], jb["tokens"],
                                         remat="none")
    with torch.no_grad():
        y, enc, cache = TM.encdec_forward(tp, tc, tb["frames"], tb["tokens"],
                                          remat="none")
        # the encoder skipped when enc_out is given
        y2, enc2, _ = TM.encdec_forward(tp, tc, None, tb["tokens"],
                                        enc_out=enc)
    assert cache is None and jcache is None and enc2 is enc
    assert tuple(enc.shape) == (2, 40, tc.d_model)
    np.testing.assert_allclose(_np(enc), np.asarray(jenc), **TOL)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    assert torch.equal(y, y2)
    xp = jax.tree.map(lambda a: np.asarray(a)[1], jp["decoder"]["xattn"])
    q_in = np.random.default_rng(3).standard_normal(
        (2, 5, jc.d_model)).astype(np.float32)
    want = JM._cross_attention(jax.tree.map(jnp.asarray, xp),
                               jnp.asarray(q_in), jenc, jc)
    with torch.no_grad():
        got = TM._cross_attention({k: torch.as_tensor(v.copy()) for k, v in
                                   xp.items()}, torch.as_tensor(q_in), enc,
                                  tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_encoder_is_causal_in_both_packages():
    """The reference's encoder masks causally (``gqa_forward``: ``q_pos =
    k_pos``); so does the port's: changing the frames after t leaves the
    encoder's output at and before t as it was, and changes it after."""
    jc, tc, jp, tp = _pair(SEAMLESS, seed=3)
    jb, tb = _batch(jc, 1, 8, seed=3, n_extra=20)
    t = 11
    frames2 = tb["frames"].clone()
    frames2[:, t + 1:] += 1.0
    outs = []
    for fr in (tb["frames"], frames2):
        with torch.no_grad():
            _, enc, _ = TM.encdec_forward(tp, tc, fr, tb["tokens"],
                                          remat="none")
        _, jenc, _ = JM.encdec_forward(jp, jc, jnp.asarray(_np(fr)),
                                       jb["tokens"], remat="none")
        outs.append((_np(enc), np.asarray(jenc)))
    for k in range(2):
        a, b = outs[0][k], outs[1][k]
        np.testing.assert_array_equal(a[:, :t + 1], b[:, :t + 1])
        assert np.abs(a[:, t + 1:] - b[:, t + 1:]).min() > 0


def test_encdec_decode_matches_full_forward_and_reference():
    """The encoder once over 16 frames, its output written into a cache
    of 16; 16 decode steps: each step's logits within 1e-4 of max|logits|
    of the full forward's, and within 1e-4 of the reference's step on the
    same cache.  The decoder's KV rows are written in place into the
    stack, ``enc_out`` is left untouched, the KV rows match the
    reference's."""
    jc, tc, jp, tp = _pair(SEAMLESS, seed=4)
    T_ = 16
    jb, tb = _batch(jc, 2, T_, seed=4)
    with torch.no_grad():
        y, enc, _ = TM.encdec_forward(tp, tc, tb["frames"], tb["tokens"],
                                      remat="none")
        full = _np(TM.logits_fn(tp, tc, y))
    caches = TM.init_cache(tc, 2, T_, torch.float32, device="cpu")
    caches["enc_out"].copy_(enc)
    before = leaves(caches)
    enc_copy = enc.clone()
    _, jenc, _ = JM.encdec_forward(jp, jc, jb["frames"], jb["tokens"],
                                   remat="none")
    jcache = JM.init_cache(jc, 2, T_, F32)
    jcache["enc_out"] = jenc
    jstep = jax.jit(lambda c, tok, pos: JM.forward_decode(
        jp, jc, c, tok, pos, compute_dtype=F32))
    scale = np.abs(full).max()
    for t in range(T_):
        with torch.no_grad():
            logits, out = TM.forward_decode(
                tp, tc, caches, tb["tokens"][:, t:t + 1], t,
                compute_dtype=torch.float32)
        assert out is caches
        want, jcache = jstep(jcache, jb["tokens"][:, t:t + 1], t)
        assert np.abs(_np(logits[:, 0]) - full[:, t]).max() < 1e-4 * scale
        np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=0,
                                   atol=1e-4)
    assert all(a is b for a, b in zip(leaves(caches), before))
    assert torch.equal(caches["enc_out"], enc_copy)
    for g, w in zip(leaves(caches["decoder"]),
                    jax.tree.leaves(jcache["decoder"])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the vision prefix
# ---------------------------------------------------------------------------

def test_vision_loss_masks_the_patches():
    """The masked loss is the cross-entropy over the text positions alone
    (the logits of the patch positions never enter it), and it still
    depends on the patches, which the text attends to."""
    jc, tc, jp, tp = _pair(LLAVA, seed=5)
    jb, tb = _batch(jc, 2, 48, seed=5)
    P = tc.num_patches
    with torch.no_grad():
        loss, _ = TM.forward_train(tp, tc, tb, remat="none",
                                   compute_dtype=torch.float32)
        x = TM.assemble_inputs(tp, tc, tb, torch.float32)
        assert tuple(x.shape) == (2, P + 48, tc.d_model)
        assert torch.equal(x[:, :P], tb["patches"])
        x, _, _ = TM.decoder_stack(tp, x, torch.arange(x.shape[1]), tc,
                                   remat="none")
        logits = TM.logits_fn(tp, tc, TM.rms_norm(x, tp["final_norm"],
                                                  tc.norm_eps))[:, P:]
        by_hand = torch.nn.functional.cross_entropy(
            logits.reshape(-1, tc.vocab_size), tb["labels"].reshape(-1))
        other = dict(tb, patches=tb["patches"] + 0.5)
        moved, _ = TM.forward_train(tp, tc, other, remat="none",
                                    compute_dtype=torch.float32)
    want, _ = JM.forward_train(jp, jc, jb, remat="none", compute_dtype=F32)
    assert abs(float(loss) / float(by_hand) - 1) < 1e-5
    assert abs(float(loss) / float(want) - 1) < 1e-5
    assert abs(float(moved) - float(loss)) > 1e-4


def test_microbatched_grads_match_full_batch(monkeypatch):
    """The port's twin of ``tests/test_system.py::
    test_microbatched_grads_match_full_batch``: llava at B 4, 16 patches
    and 48 tokens, one step at microbatch 1 and 2.  Each microbatch's
    loss sees half of every key of the batch, the patches too."""
    tc = tget(LLAVA).reduced()
    _, tb = _batch(tc, 4, 64 - tc.num_patches, seed=6)
    params = TM.init_params(tc, torch.Generator().manual_seed(0))
    s1 = tadamw.init_state(params)
    s2 = tadamw.init_state(convert.lm_params(
        convert.lm_params_numpy(params), "cpu"))
    seen = []
    real = TM.forward_train

    def spy(p, cfg, batch, **kw):
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return real(p, cfg, batch, **kw)
    monkeypatch.setattr(TM, "forward_train", spy)
    step1 = tsteps.make_train_step(tc, remat="none",
                                   compute_dtype=torch.float32)
    step2 = tsteps.make_train_step(tc, remat="none",
                                   compute_dtype=torch.float32, microbatch=2)
    s1, m1 = step1(s1, tb)
    s2, m2 = step2(s2, tb)
    assert [s["patches"] for s in seen] == \
        [(4, 16, tc.d_model), (2, 16, tc.d_model), (2, 16, tc.d_model)]
    assert [s["tokens"] for s in seen[1:]] == [(2, 48), (2, 48)]
    d = max(float((a - b).abs().max())
            for a, b in zip(leaves(s1.params), leaves(s2.params)))
    assert d < 1e-5
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4


# ---------------------------------------------------------------------------
# entry points, weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    """seamless: frames 24, tokens 10; llava: 16 patches, tokens 10."""
    jc, tc, jp, tp = _pair(arch, seed=7)
    jb, tb = _batch(jc, 2, 10, seed=7, n_extra=24)
    for b in (jb, tb):
        del b["labels"]
    want = j_make_prefill_step(jc, compute_dtype=F32)(jp, jb)
    got = tsteps.make_prefill_step(tc, compute_dtype=torch.float32)(tp, tb)
    assert tuple(got.shape) == (2, 1, tc.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_cpu(arch):
    """The reference's prefill-free loop: seamless decodes over the
    cache's zero ``enc_out``."""
    lat = []
    gen = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--cache-len",
                       "16", "--device", "cpu"], latencies=lat)
    assert gen.shape == (2, 6) and len(lat) == 6
    assert ((gen >= 0) & (gen < 256)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_and_checkpoint_carry_the_trees(arch, tmp_path):
    """``convert.lm_params`` and ``lm_train_state`` carry the reference's
    tree (seamless's ``encoder`` / ``decoder`` stacks, llava's decoder)
    leaf for leaf; a train state written by the reference's checkpointer
    is restored by the port's bit for bit, and back."""
    jc = jget(arch).reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(8), F32)
    rng = np.random.default_rng(8)
    fill = lambda t: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), F32), t)
    js = jadamw.TrainState(jnp.asarray(4, jnp.int32), jp, fill(jp), fill(jp))
    ts = convert.lm_train_state(jax.tree.map(np.asarray, js), "cpu")
    paths = ["/".join(str(k.key) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    named = [n.replace(".", "/") for n, _ in ts.params.named_parameters()]
    assert sorted(named) == sorted(paths)
    for g, w in zip(leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    back = convert.lm_params_numpy(ts.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = str(tmp_path / "ck")
    jckpt.save(path, 4, js)
    like = tadamw.init_state(TM.init_params(
        tget(arch).reduced(), torch.Generator().manual_seed(9)))
    got, _ = tckpt.restore(path, 4, like)
    assert int(got.step) == 4
    for g, w in zip(leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    tckpt.save(path, 5, got)
    again, _ = jckpt.restore(path, 5, js)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if arch == SEAMLESS:
        assert any(p.startswith("encoder/") for p in paths)
        assert any(p.startswith("decoder/xattn/") for p in paths)


def test_mesh_still_refuses():
    """Under a mesh of one, ``forward_train`` and ``encdec_forward`` on
    seamless (and ``forward_train`` on llava's masked loss) equal
    ``mesh=None`` bit for bit; an object that is not an ``LMMesh`` raises
    ``TypeError``."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    for arch in (SEAMLESS, LLAVA):
        _, tc, _, tp = _pair(arch)
        _, tb = _batch(tc, 2, 8)
        got = [TM.forward_train(tp, tc, tb, mesh=m,
                                compute_dtype=torch.float32)[0]
               for m in (None, mesh)]
        assert torch.equal(*got), arch
    _, tc, _, tp = _pair(SEAMLESS)
    _, tb = _batch(tc, 2, 8)
    got = [TM.encdec_forward(tp, tc, tb["frames"], tb["tokens"], mesh=m)[0]
           for m in (None, mesh)]
    assert torch.equal(*got)
    with pytest.raises(TypeError, match="LMMesh"):
        TM.forward_train(tp, tc, tb, mesh=object())
    with pytest.raises(TypeError, match="LMMesh"):
        TM.encdec_forward(tp, tc, tb["frames"], tb["tokens"], mesh=object())
