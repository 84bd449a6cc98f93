"""Mamba2 (with the shared attention blocks) and the xLSTM blocks of the port
(``repro_torch.models.ssm``, ``repro_torch.models.xlstm``) against the live
JAX reference on the same inputs: numpy draws from a seed, weights carried
across by ``repro_torch.convert.lm_params``.

Everything is float32 on both sides unless said, on ``reduced()`` configs
(``zamba2-2.7b``: d 64, 8 heads of 16, state 16, chunk 32;
``xlstm-350m``: d 64, 4 heads, one period of 7 mLSTM + 1 sLSTM).
Tolerances:

* Layer outputs: 1e-5 absolute plus 1e-5 relative; decode step by step
  within 1e-5 of the chunked forward and of the reference's decode, the
  caches within 1e-5 of the reference's.
* Models: the loss within 1e-5 relative; each gradient leaf within 1e-4
  relative L2 for ``zamba2-2.7b`` and 1e-3 for ``xlstm-350m``, whose
  exponential gates amplify the reference's float32 rounding (see
  ``test_xlstm_float32_error_is_the_references``).
* The Mamba2 gradient at ``ssm_chunk=256``: the chunked form's within
  1e-4 relative L2 of the gradient through the decode recurrence.
* Decode steps of a whole model: the logits within 1e-4 of the
  reference's, the caches within 1e-4 absolute plus relative.
* bfloat16 compute: the dtypes the reference keeps, values within 5e-2
  of the reference's bfloat16 run (outputs up to about 4 in size, where a
  bfloat16 ulp is 1.6e-2).
* ``sgl_prox_step``: no leaf changes (bit for bit).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import get_config as jget
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import xlstm as TX
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import leaves

F32 = jnp.float32
ARCHS = ["zamba2-2.7b", "xlstm-350m"]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = {"zamba2-2.7b": 1e-4, "xlstm-350m": 1e-3}


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(arch, **changes):
    return (dataclasses.replace(jget(arch).reduced(), **changes),
            dataclasses.replace(tget(arch).reduced(), **changes))


def _layer(jc, lname, key, seed=0):
    """Layer ``lname``'s ``key`` block of the first period of a reference
    init, unstacked, and its port copy."""
    jp = JM.init_params(jc, jax.random.PRNGKey(seed), F32)
    sub = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"][lname][key])
    return (jax.tree.map(jnp.asarray, sub),
            jax.tree.map(lambda a: torch.as_tensor(a.copy()), sub))


def _x(shape, seed=1, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x * scale), torch.as_tensor(x * scale)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(_np(got) - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 70, 20])
def test_mamba2_chunked_forward_matches_reference(S):
    """Two full chunks of 32, two and a padded ragged tail, one short
    chunk (Q = S)."""
    jc, tc = _cfgs("zamba2-2.7b")
    jp, tp = _layer(jc, "l0", "mamba")
    jx, tx = _x((2, S, jc.d_model))
    want, wc = JS.mamba2_forward(jp, jx, jc)
    with torch.no_grad():
        got, gc = TS.mamba2_forward(tp, tx, tc)
    assert wc is None and gc is None and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_mamba2_decode_matches_chunked_and_reference():
    jc, tc = _cfgs("zamba2-2.7b")
    jp, tp = _layer(jc, "l2", "mamba", seed=2)
    B, T = 2, 40
    jx, tx = _x((B, T, jc.d_model), seed=3)
    with torch.no_grad():
        full, _ = TS.mamba2_forward(tp, tx, tc)
    conv, state = TS.mamba2_cache_shape(tc, B)
    js = JS.mamba2_cache_shape(jc, B, F32)
    assert (conv, state) == (js.conv.shape, js.state.shape)
    cache = TS.MambaCache(torch.zeros(conv), torch.zeros(state))
    jcache = JS.MambaCache(jnp.zeros(conv, F32), jnp.zeros(state, F32))
    jstep = jax.jit(lambda x, c: JS.mamba2_forward(jp, x, jc, cache=c))
    for t in range(T):
        with torch.no_grad():
            got, cache = TS.mamba2_forward(tp, tx[:, t:t + 1], tc,
                                           cache=cache)
        want, jcache = jstep(jx[:, t:t + 1], jcache)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]), **TOL)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    with pytest.raises(ValueError, match="one token"):
        TS.mamba2_forward(tp, tx[:, :2], tc, cache=cache)


def _mamba_grads_ref(jp, jx, jc):
    g = jax.grad(lambda p: jnp.sum(JS.mamba2_forward(p, jx, jc)[0] ** 2))(jp)
    return jax.tree.map(np.asarray, g)


def _mamba_grads_port(tp, tx, tc, recurrence=False):
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    if recurrence:
        conv, state = TS.mamba2_cache_shape(tc, tx.shape[0])
        cache = TS.MambaCache(torch.zeros(conv), torch.zeros(state))
        ys = []
        for t in range(tx.shape[1]):
            y, cache = TS.mamba2_forward(params, tx[:, t:t + 1], tc,
                                         cache=cache)
            ys.append(y)
        y = torch.cat(ys, dim=1)
    else:
        y, _ = TS.mamba2_forward(params, tx, tc)
    keys = sorted(params)
    return dict(zip(keys, torch.autograd.grad(torch.sum(y ** 2),
                                              [params[k] for k in keys])))


def test_mamba2_gradient_at_the_published_chunk():
    """zamba2 publishes ``ssm_chunk=256``.  At one full chunk of 256 steps
    the reference's gradient is not finite (``exp`` of the unmasked upper
    triangle overflows, and the ``where`` multiplies the ``inf`` by 0);
    the port masks before the exponential: its gradient is finite and
    within 1e-4 of the gradient through its own decode recurrence.  At
    the reduced chunk of 32 the port's gradient is the reference's."""
    jc, tc = _cfgs("zamba2-2.7b", ssm_chunk=256)
    jp, tp = _layer(jc, "l0", "mamba")
    jx, tx = _x((2, 256, jc.d_model))
    ref = _mamba_grads_ref(jp, jx, jc)
    # every entry fed by dt, B or C: 2N conv channels, 2N + H in_proj columns
    assert {k: int((~np.isfinite(g)).sum()) for k, g in ref.items()} == {
        "a_log": 8, "dt_bias": 8, "conv_w": 128, "conv_b": 32,
        "in_proj": 2560, "d_skip": 0, "out_norm": 0, "out_proj": 0}
    got = _mamba_grads_port(tp, tx, tc)
    rec = _mamba_grads_port(tp, tx, tc, recurrence=True)
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
        assert _rel(g, _np(rec[k])) < 1e-4, k

    jc, tc = _cfgs("zamba2-2.7b")
    assert tc.ssm_chunk == 32
    ref = _mamba_grads_ref(jp, jx[:, :64], jc)
    got = _mamba_grads_port(tp, tx[:, :64], tc)
    for k, g in got.items():
        assert np.isfinite(ref[k]).all()
        assert _rel(g, ref[k]) < 1e-4, k


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _gates(shape, seed):
    rng = np.random.default_rng(seed)
    li = rng.standard_normal(shape).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.standard_normal(shape) + 2.0))))
    return li, lf.astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(64, 64), (64, 16), (70, 32), (9, 256)])
def test_mlstm_chunked_matches_reference(S, chunk):
    """One chunk, four, a padded ragged tail (li = NEG, lf = 0), and a
    chunk longer than S."""
    rng = np.random.default_rng(0)
    B, H, dh = 2, 4, 32
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    li, lf = _gates((B, S, H), 1)
    want = JX._mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                             chunk)
    got = TX._mlstm_chunked(*(torch.as_tensor(a) for a in (q, k, v, li, lf)),
                            chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,chunk", [(40, 256), (40, 16)])
def test_mlstm_forward_and_decode_match_reference(S, chunk):
    """``mlstm_forward`` (its default chunk of 256, and 16 with a padded
    tail) and its decode, step by step from the -1e30 stabiliser: within
    1e-5 of the chunked forward and of the reference's step; the caches
    within 1e-5 of the reference's."""
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _layer(jc, "l1", "mlstm", seed=4)
    B = 2
    jx, tx = _x((B, S, jc.d_model), seed=5)
    want, _ = JX.mlstm_forward(jp, jx, jc, chunk=chunk)
    with torch.no_grad():
        full, _ = TX.mlstm_forward(tp, tx, tc, chunk=chunk)
    np.testing.assert_allclose(_np(full), np.asarray(want), **TOL)
    shapes = TX.mlstm_cache_shape(tc, B)
    jshapes = JX.mlstm_cache_shape(jc, B, F32)
    assert shapes == tuple(s.shape for s in jshapes)
    cache = TX.MLSTMCache(*(torch.zeros(s) for s in shapes))
    cache = cache._replace(m=torch.full(shapes.m, TX.NEG))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jshapes)
    jcache = jcache._replace(m=jnp.full(jshapes.m.shape, JX.NEG, F32))
    jstep = jax.jit(lambda x, c: JX.mlstm_forward(jp, x, jc, cache=c))
    for t in range(S):
        with torch.no_grad():
            got, cache = TX.mlstm_forward(tp, tx[:, t:t + 1], tc,
                                          cache=cache)
        want, jcache = jstep(jx[:, t:t + 1], jcache)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]), **TOL)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 256])
def test_slstm_forward_matches_reference(S):
    """S 64 in one loop; S 256 through the two-level loop (two checkpointed
    chunks of 128), its gradient too."""
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _layer(jc, "l7", "slstm", seed=6)
    assert tuple(tp["up1"].shape) == (64, 64)       # int(64 * 4/3) // 64 * 64
    jx, tx = _x((2, S, jc.d_model), seed=7, scale=0.5)
    want, _ = JX.slstm_forward(jp, jx, jc)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    got, c = TX.slstm_forward(params, tx, tc)
    assert c is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if S == 256:
        jg = jax.grad(lambda p: jnp.sum(JX.slstm_forward(p, jx, jc)[0] ** 2))(
            jp)
        keys = sorted(params)
        tg = torch.autograd.grad(torch.sum(got ** 2),
                                 [params[k] for k in keys])
        for k, g in zip(keys, tg):
            assert _rel(g, jg[k]) < 1e-4, k


def test_slstm_decode_matches_forward_and_reference():
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _layer(jc, "l7", "slstm", seed=8)
    B, T = 2, 24
    jx, tx = _x((B, T, jc.d_model), seed=9, scale=0.5)
    with torch.no_grad():
        full, _ = TX.slstm_forward(tp, tx, tc)
    s = TX.slstm_cache_shape(tc, B)
    assert s == tuple(a.shape for a in JX.slstm_cache_shape(jc, B, F32))
    cache = TX.SLSTMCache(torch.zeros(s.c), torch.zeros(s.n),
                          torch.zeros(s.h), torch.full(s.m, TX.NEG))
    jcache = JX.SLSTMCache(*(jnp.zeros(s.c, F32) for _ in range(3)),
                           jnp.full(s.m, JX.NEG, F32))
    jstep = jax.jit(lambda x, c: JX.slstm_forward(jp, x, jc, cache=c))
    for t in range(T):
        with torch.no_grad():
            got, cache = TX.slstm_forward(tp, tx[:, t:t + 1], tc,
                                          cache=cache)
        want, jcache = jstep(jx[:, t:t + 1], jcache)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]), **TOL)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_xlstm_under_a_mesh_refuses():
    """``mlstm_forward`` and ``slstm_forward`` under a mesh of one equal
    ``mesh=None`` bit for bit, and their ``constrain`` calls reach the
    tally (three for q, k, v; one for the gates); an object that is not an
    ``LMMesh`` raises ``TypeError``."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_local_mesh
    _, tc = _cfgs("xlstm-350m")
    jc = jget("xlstm-350m").reduced()
    _, tm = _layer(jc, "l0", "mlstm")
    _, ts = _layer(jc, "l7", "slstm")
    _, tx = _x((2, 8, tc.d_model))
    mesh = make_local_mesh()
    for fwd, p, calls in ((TX.mlstm_forward, tm, 3),
                          (TX.slstm_forward, ts, 1)):
        want, _ = fwd(p, tx, tc)
        sh.reset_constrain_counts()
        got, _ = fwd(p, tx, tc, mesh=mesh)
        assert torch.equal(got, want)
        assert sum(sh.constrain_counts().values()) == calls
        with pytest.raises(TypeError, match="LMMesh"):
            fwd(p, tx, tc, mesh=object())


# ---------------------------------------------------------------------------
# the contraction rule
# ---------------------------------------------------------------------------

class _Largest(TorchDispatchMode):
    """The most elements any operator's output holds in its storage (a
    broadcast view holds its base's, not its shape's)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.untyped_storage().nbytes()
                                // t.element_size())
        return out


@pytest.mark.parametrize("module", ["mamba2", "mlstm"])
def test_no_intermediate_exceeds_the_bound_without_opt_einsum(module):
    """With ``opt_einsum`` off, torch contracts an einsum's operands left to
    right: a three-operand Mamba2 state update would build (B, Q, N, H, P).
    The largest tensor the forward and its backward produce stays within
    the module's bound, and the result is the same with ``opt_einsum``
    on."""
    if module == "mamba2":
        jc, tc = _cfgs("zamba2-2.7b")
        _, tp = _layer(jc, "l0", "mamba")
        B, S, Q = 2, 64, tc.ssm_chunk
        d_in = tc.ssm_expand * tc.d_model
        H, N, P = d_in // tc.ssm_head_dim, tc.ssm_state, tc.ssm_head_dim
        bound = max(B * Q * Q * H, B * S * (2 * d_in + 2 * N + H),
                    B * H * N * P)
        assert B * Q * N * H * P > bound
        run = lambda p, x: TS.mamba2_forward(p, x, tc)[0]
    else:
        jc, tc = _cfgs("xlstm-350m")
        _, tp = _layer(jc, "l0", "mlstm")
        B, S, Q = 2, 64, 32
        H, d_in = tc.num_heads, 2 * tc.d_model
        dh = d_in // H
        bound = max(B * Q * Q * H, B * S * d_in, B * H * dh * dh)
        assert B * Q * H * dh * dh > bound
        run = lambda p, x: TX.mlstm_forward(p, x, tc, chunk=Q)[0]
    _, tx = _x((B, S, tc.d_model), seed=10)
    outs = {}
    for enabled in (False, True):
        params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        prev = torch.backends.opt_einsum.enabled
        torch.backends.opt_einsum.enabled = enabled
        try:
            with _Largest() as seen:
                y = run(params, tx)
                grads = torch.autograd.grad(torch.sum(y ** 2),
                                            list(params.values()))
        finally:
            torch.backends.opt_einsum.enabled = prev
        assert seen.most <= bound, (seen.most, bound)
        outs[enabled] = (y, grads)
    torch.testing.assert_close(outs[False][0], outs[True][0], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(outs[False][1], outs[True][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------

def _pair(arch, seed=0, **changes):
    jc, tc = _cfgs(arch, **changes)
    jp = JM.init_params(jc, jax.random.PRNGKey(seed), F32)
    return jc, tc, jp, convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


@pytest.mark.parametrize("arch,layers", [("zamba2-2.7b", 12),
                                         ("xlstm-350m", 8)])
def test_loss_and_gradients_match_reference(arch, layers):
    """zamba2 at two repeats, so both ``shared_attn`` sets are applied
    (repeat r uses ``shared_attn[r % 2]``) and both get a gradient."""
    jc, tc, jp, tp = _pair(arch, seed=1, num_layers=layers)
    jb, tb = _tokens(jc, 2, 64, seed=1)
    want, jg = jax.value_and_grad(lambda p: JM.forward_train(
        p, jc, jb, remat="none", compute_dtype=F32)[0])(jp)
    loss, metrics = TM.forward_train(tp, tc, tb, remat="full",
                                     compute_dtype=torch.float32)
    assert abs(float(loss) / float(want) - 1) < 1e-5
    assert float(metrics["aux"]) == 0.0
    tg = torch.autograd.grad(loss, leaves(tp))
    assert len(tg) == len(jax.tree.leaves(jg))
    for w, g in zip(jax.tree.leaves(jg), tg):
        assert _rel(g, w) < GRAD_TOL[arch]
    if arch == "zamba2-2.7b":
        assert tc.repeats == 2
        shared = tp["shared_attn"]["attn"]["wq"]
        g = tg[[i for i, t in enumerate(leaves(tp)) if t is shared][0]]
        assert float(g[0].abs().max()) > 0 and float(g[1].abs().max()) > 0


class _AsFloat64(TorchFunctionMode):
    """Every float32 the code asks for (``.to(torch.float32)``, a
    ``dtype=`` argument) becomes float64: a float64 evaluation of modules
    that cast to float32 inside."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        swap = lambda a: torch.float64 if a is torch.float32 else a
        return func(*(swap(a) for a in args),
                    **{k: swap(v) for k, v in (kwargs or {}).items()})


def test_xlstm_float32_error_is_the_references():
    """Why the xLSTM's logits bar is 1e-4 of max|logits|: against a float64
    evaluation of the same model (the port's, every float32 made float64),
    the reference's float32 logits lie further off than the port's (1.4e-4
    against 4.7e-5 at max|logits| 4.5 on reduced xlstm, T 48), and both
    within 1e-4 of max|logits|."""
    jc, tc, jp, tp = _pair("xlstm-350m")
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 48))

    def port(params, dtype):
        with torch.no_grad():
            x = TM.embed_tokens(params, tc, torch.as_tensor(toks), dtype)
            x, _, _ = TM.decoder_stack(params, x, torch.arange(48), tc,
                                       remat="none")
            return _np(TM.logits_fn(params, tc, TM.rms_norm(
                x, params["final_norm"], tc.norm_eps))).astype(np.float64)

    x = JM.embed_tokens(jp, jc, jnp.asarray(toks, jnp.int32), F32)
    x, _, _ = JM.decoder_stack(jp, x, jnp.arange(48), jc, remat="none")
    ref = np.asarray(JM.logits_fn(jp, jc, JM.rms_norm(
        x, jp["final_norm"], jc.norm_eps)), np.float64)
    got = port(tp, torch.float32)
    with _AsFloat64():
        truth = port(convert.lm_params(jax.tree.map(
            lambda a: np.asarray(a, np.float64), jp), "cpu"), torch.float64)
    e_port, e_ref = np.abs(got - truth).max(), np.abs(ref - truth).max()
    assert e_port <= e_ref < 1e-4 * np.abs(truth).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference(arch):
    """Leaf order, shapes and dtypes of the reference's ``init_cache`` at a
    bfloat16 cache (float32 states, bfloat16 rings and KV rows), the
    stabilisers at -1e30, everything else 0."""
    jc, tc = _cfgs(arch)
    want = jax.tree.leaves(JM.init_cache(jc, 3, 40, jnp.bfloat16))
    got = leaves(TM.init_cache(tc, 3, 40, torch.bfloat16, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g.float()),
                                      np.asarray(w, np.float32))
    assert any(float(g.min()) == float(np.float32(-1e30)) for g in got) == \
        (arch == "xlstm-350m")


@pytest.mark.parametrize("arch,layers", [("zamba2-2.7b", 12),
                                         ("xlstm-350m", 8)])
def test_decode_writes_every_cache_in_place(arch, layers):
    """Three decode steps keep every cache tensor (the stack's own
    storage) and change each leaf (zamba2 at two repeats: both slices of
    the stack, both shared blocks' KV caches); each step's logits within
    1e-4 of the reference's step, the caches within 1e-4 absolute plus
    relative."""
    jc, tc, jp, tp = _pair(arch, seed=2, num_layers=layers)
    caches = TM.init_cache(tc, 2, 8, torch.float32, device="cpu")
    before = leaves(caches)
    copies = [t.clone() for t in before]
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 3))
    jcache = JM.init_cache(jc, 2, 8, F32)
    for t in range(3):
        with torch.no_grad():
            logits, out = TM.forward_decode(
                tp, tc, caches, torch.as_tensor(toks[:, t:t + 1]), t,
                compute_dtype=torch.float32)
        assert out is caches
        want, jcache = JM.forward_decode(
            jp, jc, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32), t,
            compute_dtype=F32)
        np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=0,
                                   atol=1e-4)
    after = leaves(caches)
    assert all(a is b for a, b in zip(after, before))
    for g, c, w in zip(after, copies, jax.tree.leaves(jcache)):
        assert all(not torch.equal(g[r], c[r]) for r in range(tc.repeats))
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("module", ["mamba2", "mlstm", "slstm"])
def test_bf16_compute_keeps_the_references_dtypes(module):
    """bfloat16 activations with float32 weights, a decode step from a
    bfloat16 ring: outputs bfloat16, states float32, the ring bfloat16;
    values within 5e-2 of the reference's bfloat16 run."""
    arch = "zamba2-2.7b" if module == "mamba2" else "xlstm-350m"
    jc, tc = _cfgs(arch)
    lname, key = {"mamba2": ("l0", "mamba"), "mlstm": ("l0", "mlstm"),
                  "slstm": ("l7", "slstm")}[module]
    jp, tp = _layer(jc, lname, key, seed=11)
    jx, tx = _x((2, 40, jc.d_model), seed=12, scale=0.5)
    jmod, tmod = {"mamba2": (JS.mamba2_forward, TS.mamba2_forward),
                  "mlstm": (JX.mlstm_forward, TX.mlstm_forward),
                  "slstm": (JX.slstm_forward, TX.slstm_forward)}[module]
    want, _ = jmod(jp, jx.astype(jnp.bfloat16), jc)
    with torch.no_grad():
        got, _ = tmod(tp, tx.to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got.float()), np.asarray(want.astype(F32)),
                               atol=5e-2)
    jshape = {"mamba2": lambda: JS.mamba2_cache_shape(jc, 2, jnp.bfloat16),
              "mlstm": lambda: JX.mlstm_cache_shape(jc, 2, jnp.bfloat16),
              "slstm": lambda: JX.slstm_cache_shape(jc, 2, jnp.bfloat16)}
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jshape[module]())
    if module != "mamba2":
        jcache = jcache._replace(m=jnp.full(jcache.m.shape, JX.NEG, F32))
    cache = type(jcache)(*(torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in jcache))
    want, jnew = jmod(jp, jx[:, :1].astype(jnp.bfloat16), jc, cache=jcache)
    with torch.no_grad():
        got, new = tmod(tp, tx[:, :1].to(torch.bfloat16), tc, cache=cache)
    assert got.dtype == torch.bfloat16
    for g, w in zip(new, jnew):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(_np(g.float()), np.asarray(w, np.float32),
                                   atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_sgl_prox_step_changes_no_leaf(arch):
    """``head_groups_for`` names ``attn/wq`` and ``ffn/w_in`` under
    ``blocks``: a Mamba2, mLSTM or sLSTM layer has neither, and
    ``shared_attn`` sits outside ``blocks``.  The reference's prox leaves
    every leaf as it was, and so does the port's."""
    jc, tc, jp, tp = _pair(arch, seed=4)
    before = [t.detach().clone() for t in leaves(tp)]
    want = jtrain.sgl_prox_step(jp, jc, 5.0, 5.0)
    got = ttrain.sgl_prox_step(tp, tc, 5.0, 5.0)
    assert got is tp
    for g, b, w, j in zip(leaves(got), before, jax.tree.leaves(want),
                          jax.tree.leaves(jp)):
        assert torch.equal(g, b)
        np.testing.assert_array_equal(np.asarray(w), np.asarray(j))


def test_checkpoint_both_ways_zamba2(tmp_path):
    """zamba2's reduced train state (the ``shared_attn`` stack, the Mamba2
    leaves) written by the reference, restored by the port bit for bit,
    and back; xLSTM's ``r_gates`` / ``w_if`` come in the reference's
    order too."""
    jc = jget("zamba2-2.7b").reduced()
    jp = JM.init_params(jc, jax.random.PRNGKey(5), F32)
    rng = np.random.default_rng(5)
    fill = lambda t: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), F32), t)
    js = jadamw.TrainState(jnp.asarray(6, jnp.int32), jp, fill(jp), fill(jp))
    path = str(tmp_path / "ck")
    jckpt.save(path, 6, js)
    like = tadamw.init_state(TM.init_params(
        tget("zamba2-2.7b").reduced(), torch.Generator().manual_seed(9)))
    got, _ = tckpt.restore(path, 6, like)
    assert "shared_attn" in got.params and int(got.step) == 6
    for g, w in zip(leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    tckpt.save(path, 7, got)
    back, _ = jckpt.restore(path, 7, js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    xc = jget("xlstm-350m").reduced()
    xp = JM.init_params(xc, jax.random.PRNGKey(6), F32)
    paths = ["/".join(str(k.key) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(xp)[0]]
    named = [n.replace(".", "/") for n, _ in convert.lm_params(
        jax.tree.map(np.asarray, xp), "cpu").named_parameters()]
    assert sorted(named) == sorted(paths)
    tx = convert.lm_params(jax.tree.map(np.asarray, xp), "cpu")
    for path, leaf, want in zip(paths, leaves(tx), jax.tree.leaves(xp)):
        np.testing.assert_array_equal(_np(leaf), np.asarray(want))
    assert any(p.endswith("slstm/r_gates") for p in paths)
    assert any(p.endswith("mlstm/w_if") for p in paths)


def test_train_and_serve_clis_on_the_new_families():
    """``train.main`` on reduced zamba2 and xlstm (losses finite, the
    per-step aux 0) and ``serve.main`` on both."""
    from repro_torch.launch import serve as tserve
    for arch, seq in (("zamba2-2.7b", 32), ("xlstm-350m", 32)):
        metrics = []
        losses = ttrain.main(
            ["--arch", arch, "--smoke", "--steps", "2", "--global-batch",
             "2", "--seq", str(seq), "--lr", "1e-2", "--device", "cpu"],
            step_metrics=metrics)
        assert len(losses) == 2 and np.isfinite(losses).all()
        assert [m["aux"] for m in metrics] == [0.0, 0.0]
        gen = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                           "--prompt-len", "4", "--gen", "6", "--cache-len",
                           "16", "--device", "cpu"])
        assert gen.shape == (2, 6)
