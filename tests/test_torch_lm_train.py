"""The port's LM training path against the live JAX reference: AdamW and
its schedule, gradient accumulation, the SGL weight prox and its group
axes, TLFre certification of weight groups, the synthetic data stream, the
checkpoint layout in both directions, and the three CLIs on the CPU.

Tolerances (float32 on both sides):

* ``cosine_schedule``: 1e-6 relative; one ``adamw_update`` from equal
  gradients (the clip engaged): parameters and moments within 1e-6.
* ``microbatch=2`` against the full batch (the port's own): loss 1e-6
  relative; the first moment after one step from zero moments, which is
  ``(1 - b1)`` times the clipped gradient, within 1e-5 relative.
* A 20-step loss trajectory from equal weights, the SGL prox applied after
  every step on both sides: 1e-3 relative.
* ``sgl_weight_prox`` / ``sgl_weight_penalty`` / ``sgl_prox_step``:
  1e-6 (the reference's threshold is computed in float64 under the
  suite's x64 mode, the port's in float32); ``group_sparsity_stats`` and
  the group axes equal.
* ``certify_inactive_groups`` / ``prune_step`` (float64): keep masks equal,
  every certified group zero in the exact solution.
* ``SyntheticLM``: tokens equal.  Checkpoints: every leaf bit for bit.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import get_config as jget
from repro.data.lm_data import SyntheticLM as JData
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.sparsity import group_reg as jgr
from repro.sparsity import prune as jprune
import repro.core as J
from repro_torch import convert
import repro_torch.core as T
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import get_config as tget
from repro_torch.data.lm_data import SyntheticLM as TData
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step as t_make_train_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import leaves
from repro_torch.sparsity import group_reg as tgr
from repro_torch.sparsity import prune as tprune

F32 = jnp.float32


def _np(t):
    return t.detach().cpu().numpy()


def _pair(cfg_j, cfg_t, seed=0):
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(seed), F32)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


def _close_trees(got, want, rtol, atol):
    got_l, want_l = leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    kw = dict(base_lr=1e-3, warmup=20, total=100)
    for step in range(0, 130, 3):
        want = float(jadamw.cosine_schedule(jnp.asarray(step, jnp.int32),
                                            **kw))
        got = float(tadamw.cosine_schedule(torch.tensor(step,
                                                        dtype=torch.int32),
                                           **kw))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert float(tadamw.cosine_schedule(torch.tensor(0), **kw)) == 0.0


def test_adamw_update_matches_reference():
    jc, tc = jget("gemma2-2b").reduced(), tget("gemma2-2b").reduced()
    jp, tp = _pair(jc, tc)
    rng = np.random.default_rng(0)
    shapes = [np.asarray(l).shape for l in jax.tree.leaves(jp)]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [rng.standard_normal(s).astype(np.float32) * 0.01 for s in shapes]
    v = [rng.random(s).astype(np.float32) * 1e-4 for s in shapes]
    td = jax.tree.structure(jp)
    js = jadamw.TrainState(jnp.asarray(3, jnp.int32), jp,
                           jax.tree.unflatten(td, [jnp.asarray(a) for a in m]),
                           jax.tree.unflatten(td, [jnp.asarray(a) for a in v]))
    ts = convert.lm_train_state(js, "cpu")
    want = jadamw.adamw_update(
        js, jax.tree.unflatten(td, [jnp.asarray(g) for g in grads]), lr=1e-3)
    got = tadamw.adamw_update(ts, [torch.as_tensor(g) for g in grads],
                              lr=torch.tensor(1e-3))
    assert int(got.step) == int(want.step) == 4
    assert got.step.dtype == torch.int32
    for name in ("params", "m", "v"):
        _close_trees(getattr(got, name), getattr(want, name), 1e-6, 1e-6)
    # the update is in place: the port's state holds the new values
    assert got.params is ts.params and leaves(got.m)[0] is leaves(ts.m)[0]


def test_microbatch_matches_full_batch():
    tc = tget("gemma3-12b").reduced()
    kw = dict(remat="none", compute_dtype=torch.float32,
              lr_kwargs=dict(base_lr=1e-2, warmup=1, total=10))
    states, losses = [], []
    for mb in (1, 2):
        params = TM.init_params(tc, torch.Generator().manual_seed(1))
        state = tadamw.TrainState(torch.tensor(2, dtype=torch.int32),
                                  *tadamw.init_state(params)[1:])
        _, tb = _batch(tc.vocab_size, 4, 16, seed=2)
        state, metrics = t_make_train_step(tc, microbatch=mb, **kw)(state,
                                                                    tb)
        states.append(state)
        losses.append(float(metrics["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    for a, b in zip(leaves(states[0].m), leaves(states[1].m)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)


def test_bf16_compute_with_cast_params_matches_reference():
    """``compute_dtype=bfloat16`` with ``cast_params``: the >= 2-D weights
    are cast inside the loss, the float32 master takes the update.  Two
    steps' losses within 2e-2 relative of the reference's (bf16 rounding
    on both sides), the master weights still float32."""
    jc, tc = jget("gemma2-2b").reduced(), tget("gemma2-2b").reduced()
    jp, tp = _pair(jc, tc, seed=6)
    lr_kwargs = dict(base_lr=1e-2, warmup=1, total=10)
    jstep = jax.jit(j_make_train_step(jc, remat="none",
                                      compute_dtype=jnp.bfloat16,
                                      lr_kwargs=lr_kwargs))
    tstep = t_make_train_step(tc, remat="full", compute_dtype=torch.bfloat16,
                              lr_kwargs=lr_kwargs)
    js, ts = jadamw.init_state(jp), tadamw.init_state(tp)
    for i in range(2):
        jb, tb = _batch(jc.vocab_size, 2, 16, seed=30 + i)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=2e-2)
    assert all(p.dtype == torch.float32 for p in leaves(ts.params))
    assert int(ts.step) == 2


def test_loss_trajectory_with_prox_matches_reference():
    """20 steps of the reference's jitted step and the port's eager one
    from equal weights on equal batches, ``sgl_prox_step`` after each."""
    jc, tc = jget("gemma2-2b").reduced(), tget("gemma2-2b").reduced()
    jp, tp = _pair(jc, tc, seed=3)
    lr_kwargs = dict(base_lr=1e-2, warmup=2, total=100)
    jstep = jax.jit(j_make_train_step(jc, remat="none", compute_dtype=F32,
                                      lr_kwargs=lr_kwargs))
    tstep = t_make_train_step(tc, remat="none", compute_dtype=torch.float32,
                              lr_kwargs=lr_kwargs)
    js, ts = jadamw.init_state(jp), tadamw.init_state(tp)
    t1, t2 = 1e-2 * 3e-2, 1e-2 * 3e-3
    jl, tl = [], []
    for i in range(20):
        jb, tb = _batch(jc.vocab_size, 4, 32, seed=i)
        js, jm = jstep(js, jb)
        js = js._replace(params=jtrain.sgl_prox_step(js.params, jc, t1, t2))
        ts, tm = tstep(ts, tb)
        ttrain.sgl_prox_step(ts.params, tc, t1, t2)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tgr.group_sparsity_stats(
        ts.params["blocks"]["l0"]["ffn"]["w_in"], 2)["weight_sparsity"] > 0


# ---------------------------------------------------------------------------
# the SGL weight prox and its groups
# ---------------------------------------------------------------------------

def _same_stats(got, want):
    """Counts equal; the sparsity fraction within 1e-6 (the reference's
    mean is float64 under x64, the port's float32)."""
    assert (got["groups"], got["inactive"]) == (want["groups"],
                                                want["inactive"])
    assert got["weight_sparsity"] == pytest.approx(want["weight_sparsity"],
                                                   rel=1e-6)


@pytest.mark.parametrize("shape,axis", [((3, 8, 5, 4), 2), ((3, 16, 24), 2),
                                        ((4, 8, 16), 1)])
def test_sgl_weight_prox_matches_reference(shape, axis):
    w = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * 0.01).astype(np.float32)
    for t1, t2 in ((0.0, 0.0), (1e-4, 2e-3), (5e-3, 1e-3), (0.05, 0.001)):
        want = np.asarray(jgr.sgl_weight_prox(jnp.asarray(w), axis, t1, t2))
        got = tgr.sgl_weight_prox(torch.as_tensor(w), axis, t1, t2)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-9)
        _same_stats(tgr.group_sparsity_stats(got, axis),
                    jgr.group_sparsity_stats(jnp.asarray(want), axis))
    want = float(jgr.sgl_weight_penalty(jnp.asarray(w), axis, 0.3, 0.2))
    got = float(tgr.sgl_weight_penalty(torch.as_tensor(w), axis, 0.3, 0.2))
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(
        _np(tgr.leaf_group_norms(torch.as_tensor(w), axis)),
        np.asarray(jgr.leaf_group_norms(jnp.asarray(w), axis)), rtol=1e-6)


@pytest.mark.parametrize("shape,n,rec", [
    ((13, 2304, 8, 256), 8, 2), ((13, 2304, 9216), 4096, 2),
    ((6, 512, 2048), 2048, 2), ((4, 8, 8), 8, 1), ((2, 3, 5), 7, 2),
    ((5, 7), 5, 1)])
def test_resolve_group_axis_matches_reference(shape, n, rec):
    assert ttrain._resolve_group_axis(shape, n, rec) == \
        jtrain._resolve_group_axis(shape, n, rec)


@pytest.mark.parametrize("d_ff", [128, 4100])
def test_sgl_prox_step_matches_reference(d_ff):
    """Reduced gemma2 with its own d_ff (the channel groups match axis 2)
    and with d_ff 4100 (4096 groups match no axis: the fallback)."""
    jc = dataclasses.replace(jget("gemma2-2b").reduced(), d_ff=d_ff)
    tc = dataclasses.replace(tget("gemma2-2b").reduced(), d_ff=d_ff)
    jp, tp = _pair(jc, tc, seed=4)
    want = jtrain.sgl_prox_step(jp, jc, 2e-2, 1e-2)
    got = ttrain.sgl_prox_step(tp, tc, 2e-2, 1e-2)
    assert got is tp
    _close_trees(got, want, 1e-6, 1e-9)
    wq = got["blocks"]["l1"]["attn"]["wq"]
    _same_stats(tgr.group_sparsity_stats(wq, 2), jgr.group_sparsity_stats(
        want["blocks"]["l1"]["attn"]["wq"], 2))


def _problem(seed=0, N=40, G=20, n=5):
    """``tests/test_grid_screening.py``'s problem."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 4, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, G, n


@pytest.mark.parametrize("lam_frac", [0.9, 0.5, 0.2])
def test_certify_inactive_groups_matches_reference_and_is_safe(lam_frac):
    X, y, G, n = _problem(7)
    jspec = J.GroupSpec.uniform_groups(G, n)
    tspec = T.GroupSpec.uniform_groups(G, n, device="cpu")
    lam_max = float(J.lambda_max_sgl(jspec, jnp.asarray(X.T @ y), 1.0)[0])
    lam = lam_frac * lam_max
    want = jprune.certify_inactive_groups(jnp.asarray(X), jnp.asarray(y),
                                          jspec, 1.0, lam)
    got = tprune.certify_inactive_groups(torch.as_tensor(X),
                                         torch.as_tensor(y), tspec, 1.0, lam)
    np.testing.assert_array_equal(_np(got.group_keep),
                                  np.asarray(want.group_keep))
    np.testing.assert_array_equal(_np(got.feat_keep),
                                  np.asarray(want.feat_keep))
    sol = T.solve_sgl(torch.as_tensor(X), torch.as_tensor(y), tspec, lam,
                      1.0, T.spectral_norm(torch.as_tensor(X)) ** 2,
                      tol=1e-13, max_iter=100_000)
    beta = _np(sol.beta).reshape(G, n)
    assert np.all(np.abs(beta[~_np(got.group_keep)]) < 1e-9)


def test_screen_weight_groups_matches_reference():
    """TLFre layer 1 on the linearised subproblem from a dual point below
    lambda_max: the reference's keep masks and sups."""
    X, y, G, n = _problem(11)
    jspec = J.GroupSpec.uniform_groups(G, n)
    tspec = T.GroupSpec.uniform_groups(G, n, device="cpu")
    lam_max = float(J.lambda_max_sgl(jspec, jnp.asarray(X.T @ y), 1.0)[0])
    lam_bar, lam = 0.8 * lam_max, 0.5 * lam_max
    sol = T.solve_sgl(torch.as_tensor(X), torch.as_tensor(y), tspec,
                      lam_bar, 1.0, T.spectral_norm(torch.as_tensor(X)) ** 2,
                      tol=1e-13, max_iter=100_000)
    theta = _np(sol.theta)
    want = jgr.screen_weight_groups(jnp.asarray(X), jnp.asarray(y), jspec,
                                    1.0, lam, lam_bar, jnp.asarray(theta))
    got = tgr.screen_weight_groups(torch.as_tensor(X), torch.as_tensor(y),
                                   tspec, 1.0, lam, lam_bar,
                                   torch.as_tensor(theta))
    np.testing.assert_array_equal(_np(got.group_keep),
                                  np.asarray(want.group_keep))
    np.testing.assert_array_equal(_np(got.feat_keep),
                                  np.asarray(want.feat_keep))
    assert 0 < int(got.group_keep.sum()) < G


@pytest.mark.parametrize("lam", [1e3, 0.5])
def test_prune_step_matches_reference(lam):
    rng = np.random.default_rng(0)
    n_groups = 16
    acts = rng.standard_normal((64, n_groups))
    resid = rng.standard_normal(64) * 0.1
    w = rng.standard_normal((8, n_groups, 4)).astype(np.float32)
    jw, jkeep, jn = jprune.prune_step(jnp.asarray(w), 1, jnp.asarray(acts),
                                      jnp.asarray(resid), alpha=1.0, lam=lam)
    tw, tkeep, tn = tprune.prune_step(torch.as_tensor(w), 1,
                                      torch.as_tensor(acts),
                                      torch.as_tensor(resid), alpha=1.0,
                                      lam=lam)
    assert tn == jn and (lam < 1e3 or tn == n_groups)
    np.testing.assert_array_equal(_np(tkeep), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

def test_synthetic_lm_tokens_equal_reference():
    jd, td = JData(1000, 32, 4, seed=3), TData(1000, 32, 4, seed=3)
    for step in (17, 0, 3):
        for fn in ("batch_at", "fast_batch_at"):
            want, got = getattr(jd, fn)(step), getattr(td, fn)(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(_np(got[k]),
                                              np.asarray(want[k]))


@pytest.mark.parametrize("shifted", [False, True])
def test_synthetic_lm_threaded_draws_equal_reference(monkeypatch, shifted):
    """From ``PARALLEL_MIN`` Gumbel draws a position, threads draw them
    from advanced copies of the generator; the tokens stay the
    reference's, also where a position's draws shifted the stream (the
    rest are then drawn in order)."""
    from repro_torch.data import lm_data
    V, S, B = 4096, 24, 16
    assert B * V >= lm_data.PARALLEL_MIN
    if shifted:
        real = lm_data._draw_row
        monkeypatch.setattr(lm_data, "_draw_row", lambda base, i, shape: (
            real(base, i, shape)[0], i != 7))
    jd, td = JData(V, S, B, seed=1), TData(V, S, B, seed=1)
    for step in (0, 5):
        want, got = jd.batch_at(step), td.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def _ref_state(arch="gemma2-2b", seed=5):
    cfg = jget(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), F32)
    rng = np.random.default_rng(seed)
    fill = lambda t: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), F32), t)
    return jadamw.TrainState(jnp.asarray(7, jnp.int32), jp, fill(jp),
                             fill(jp))


def _port_like(arch="gemma2-2b"):
    params = TM.init_params(tget(arch).reduced(),
                            torch.Generator().manual_seed(9))
    return tadamw.init_state(params)


def test_checkpoint_reference_writes_port_restores(tmp_path):
    js = _ref_state()
    path = str(tmp_path / "ck")
    jckpt.save(path, 7, js, metadata={"mesh": {"data": 1}})
    assert tckpt.latest_step(path) == 7
    got, manifest = tckpt.restore(path, 7, _port_like())
    assert isinstance(got, tadamw.TrainState)
    assert got.step.dtype == torch.int32 and int(got.step) == 7
    _close_trees(got, js, 0, 0)
    assert dict(got.params.named_parameters()).keys() == \
        dict(_port_like().params.named_parameters()).keys()
    assert manifest["metadata"]["mesh"] == {"data": 1}


def test_checkpoint_port_writes_reference_restores(tmp_path):
    ts = convert.lm_train_state(_ref_state(seed=6), "cpu")
    path = str(tmp_path / "ck")
    tckpt.save(path, 3, ts, metadata={"device": "cpu"})
    like = _ref_state(seed=1)
    got, manifest = jckpt.restore(path, 3, like)
    _close_trees(ts, got, 0, 0)
    assert manifest["n_leaves"] == len(jax.tree.leaves(like))
    back = convert.lm_train_state_numpy(ts)
    assert int(back["step"]) == 7
    for a, b in zip(jax.tree.leaves(back["v"]), jax.tree.leaves(got.v)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoint_structure_and_shape_mismatch_refused(tmp_path):
    path = str(tmp_path / "ck")
    jckpt.save(path, 1, _ref_state())
    with pytest.raises(ValueError, match="structure changed"):
        tckpt.restore(path, 1, _port_like("gemma3-12b"))
    wide = tadamw.init_state(TM.init_params(
        dataclasses.replace(tget("gemma2-2b").reduced(), d_ff=96),
        torch.Generator()))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, 1, wide)
    # the reference refuses the port's checkpoint of another structure too
    tckpt.save(path, 2, _port_like("gemma3-12b"))
    with pytest.raises(ValueError, match="structure changed"):
        jckpt.restore(path, 2, _ref_state())


def test_async_checkpointer_snapshots_and_retains(tmp_path):
    path = str(tmp_path / "ck2")
    w = tckpt.AsyncCheckpointer(path, keep=2)
    a = torch.arange(10, dtype=torch.float32)
    tree = {"a": a, "b": {"c": torch.ones((3, 3))}}
    for s in (10, 20, 30):
        w.save(s, tree)
        a.add_(1.0)                  # an in-place update after the save
    w.close()
    assert tckpt.latest_step(path) == 30
    assert sorted(os.listdir(path)) == ["step_00000020", "step_00000030"]
    got, _ = jckpt.restore(path, 30, {"a": jnp.zeros(10), "b": {
        "c": jnp.zeros((3, 3))}})
    np.testing.assert_array_equal(np.asarray(got["a"]), np.arange(10) + 2.0)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

COMMON = ["--arch", "gemma2-2b", "--smoke", "--global-batch", "2", "--seq",
          "32", "--lr", "1e-2", "--sgl-lambda", "3e-2", "--device", "cpu"]


def test_train_main_resumes_exactly(tmp_path, capsys):
    losses, state = ttrain.main(COMMON + ["--steps", "4"], return_state=True)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert "sparsity {'groups': 64" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    times = []
    ttrain.main(COMMON + ["--steps", "2", "--ckpt-dir", ck, "--ckpt-every",
                          "2"], step_times=times)
    assert len(times) == 2 and tckpt.latest_step(ck) == 2
    resumed, state2 = ttrain.main(COMMON + ["--steps", "4", "--ckpt-dir", ck,
                                            "--resume"], return_state=True)
    np.testing.assert_allclose(resumed, losses[2:], rtol=1e-6)
    for a, b in zip(leaves(state), leaves(state2)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_main_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "gemma2-2b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "gemma2-2b", "--smoke"])


def test_lm_converters_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    js = _ref_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params(js.params)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_train_state(js)


def test_train_main_on_seamless_fails_as_the_references():
    """``train.main``'s data stream draws tokens alone, so the enc-dec
    loss finds no ``frames``: the reference's ``KeyError``, and the
    port's."""
    argv = ["--arch", "seamless-m4t-medium", "--smoke", "--steps", "1",
            "--global-batch", "2", "--seq", "16"]
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(argv)
    with pytest.raises(KeyError, match="frames"):
        ttrain.main(argv + ["--device", "cpu"])


def test_serve_main_cpu(capsys):
    lat = []
    gen = tserve.main(["--arch", "gemma2-2b", "--smoke", "--batch", "2",
                       "--prompt-len", "6", "--gen", "40", "--cache-len",
                       "48", "--device", "cpu"], latencies=lat)
    assert gen.shape == (2, 40) and len(lat) == 40
    assert ((gen >= 0) & (gen < 256)).all()
    assert "p99=" in capsys.readouterr().out


def test_example_driver_cpu(capsys):
    from repro_torch.examples import sgl_pruned_lm as ex
    out = ex.main(["--smoke", "--steps", "8", "--device", "cpu"])
    assert out["losses"][-1] < out["losses"][0]
    res, surv = out["curve"], out["surviving"]
    assert len(out["signal"]) == 128 and len(res.lambdas) == 24
    assert surv[0] == 0 and np.all(np.diff(surv) >= 0) and surv[-1] > 0
    text = capsys.readouterr().out
    assert "pruning-threshold curve" in text and "round-trips" in text
    # the float64 twin keeps the same channels on every row
    _, surv64 = ex.pruning_threshold_curve(out["signal"], device="cpu",
                                           dtype=torch.float64)
    np.testing.assert_array_equal(surv64, surv)
