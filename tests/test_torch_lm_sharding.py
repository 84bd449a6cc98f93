"""The port's sharding rules and gradient compression against the live JAX
reference, with no ranks: every spec is resolved from descriptors or
shapes alone, so the full-width configurations cost nothing.

* ``param_pspecs`` / ``state_pspecs``: ``tuple()`` of every leaf equals the
  reference's, for the ten registered configs on the production meshes
  (single and multi pod) and on (2, 1), (1, 2) and (2, 2).
* ``cache_pspecs`` for the ten at (batch 128, cache 32 768) and at (batch
  1, cache 32 768), where the caches fall back to the sequence; and
  ``batch_pspec``.
* ``resolve_spec``'s divisibility fallback (the reference's three cases of
  ``tests/test_distributed.py``) and ``constrain``'s resolution by hand.
* ``make_local_mesh()`` without a process group is a mesh of one;
  ``make_production_mesh`` refuses a world of 1.
* Compression: int8 payload and scales equal to the reference's bit for
  bit on the same float32 input, the error and ``decompress`` within 1e-7,
  the reference's three properties on its ``rand_cases``, ``wire_bytes``
  equal.
"""
import copy
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from conftest import rand_cases
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jget, list_archs
from repro.distributed import compression as JCmp
from repro.distributed import sharding as jsh
from repro.models import common as JC
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.configs.base import get_config as tget
from repro_torch.distributed import compression as TCmp
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as TMesh
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.pytree import flatten, leaves

EXAMPLE = "gemma2-100m"   # either package's example registers it at run time
ARCHS = [a for a in list_archs() if a != EXAMPLE]
MESHES = {
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
    "16x16": {"data": 16, "model": 16},
    "2x1": {"data": 2, "model": 1},
    "1x2": {"data": 1, "model": 2},
    "2x2": {"data": 2, "model": 2},
}


def _jspecs(tree):
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _tspecs(tree):
    return [tuple(s) for s in leaves(tree, is_leaf=TC.is_spec)]


def test_arch_registries_agree():
    from repro_torch.configs.base import list_archs as tlist
    assert [a for a in tlist() if a != EXAMPLE] == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh):
    shape = MESHES[mesh]
    want = JM.param_pspecs(jget(arch), shape)
    got = TM.param_pspecs(tget(arch), shape)
    assert _tspecs(got) == _jspecs(want)
    assert all(type(s) is TC.P for s in leaves(got, is_leaf=TC.is_spec))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspecs_match_reference(arch):
    for shape in MESHES.values():
        want = jadamw.state_pspecs(JM.param_pspecs(jget(arch), shape))
        got = tadamw.state_pspecs(TM.param_pspecs(tget(arch), shape))
        assert isinstance(got, tadamw.TrainState)
        assert tuple(got.step) == tuple(want.step) == ()
        for field in ("params", "m", "v"):
            assert _tspecs(getattr(got, field)) == \
                _jspecs(getattr(want, field)), (shape, field)


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, batch):
    """Leaf for leaf in the reference's order, and one spec per leaf of the
    port's ``cache_shapes`` (the stacked ``None`` axis included)."""
    for shape in MESHES.values():
        want = jsh.cache_pspecs(jget(arch), batch, 32768, shape)
        got = tsh.cache_pspecs(tget(arch), batch, 32768, shape)
        assert _tspecs(got) == _jspecs(want), shape
        shapes = leaves(TM.cache_shapes(tget(arch), batch, 32768),
                        is_leaf=lambda x: isinstance(x, TM.TensorSpec))
        specs = leaves(got, is_leaf=TC.is_spec)
        if tget(arch).family != "encdec":
            assert [len(s) for s in specs] == [len(t.shape) for t in shapes]


def test_cache_pspecs_sequence_fallback():
    """At batch 1 the KV caches shard the sequence over the data axes (4
    KV heads do not divide 16 model ranks)."""
    got = tsh.cache_pspecs(tget("gemma2-2b"), 1, 32768, MESHES["16x16"])
    for kind in ("l0", "l1"):
        kv = got["blocks"][kind]
        assert tuple(kv.k) == tuple(kv.v) == (None, None, "data", None,
                                              None)


@pytest.mark.parametrize("batch", [256, 32, 3, 1])
def test_batch_pspec_matches_reference(batch):
    for arch in ("gemma2-2b", "seamless-m4t-medium"):
        for shape in MESHES.values():
            want = jsh.batch_pspec(jget(arch), "train_4k", shape, batch)
            got = tsh.batch_pspec(tget(arch), "train_4k", shape, batch)
            assert sorted(got) == sorted(want)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}


def test_resolve_spec_divisibility_fallback():
    """The reference's three cases (``tests/test_distributed.py``)."""
    big = MESHES["pod2x16x16"]
    d = TC.ParamDesc((1024, 8, 128), ("embed", "kv_heads", None))
    assert tuple(TC.resolve_spec(d, big)) == (("pod", "data"), None, None)
    d = TC.ParamDesc((1024, 96, 128), ("embed", "heads", None))
    assert TC.resolve_spec(d, big)[1] == "model"
    spec = TC.resolve_spec(TC.ParamDesc((1024, 96), ("embed", "heads")),
                           MESHES["16x16"])
    assert tuple(spec) == ("data", "model")
    for desc in (TC.ParamDesc((1024, 8, 128), ("embed", "kv_heads", None)),
                 TC.ParamDesc((6, 96), ("embed", "heads"))):
        for shape in MESHES.values():
            jd = JC.ParamDesc(desc.shape, desc.axes)
            assert tuple(TC.resolve_spec(desc, shape)) == \
                tuple(JC.resolve_spec(jd, shape))


def test_spec_is_a_tuple_that_pickles():
    s = TC.P(("pod", "data"), None, "model")
    assert tuple(s) == (("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(copy.deepcopy(s)) is TC.P
    assert TC.P() == () and repr(TC.P(None, "model")) == "P(None, 'model')"


@pytest.mark.parametrize("case", [
    # (shape, mesh, parts, want): the reference's constrain rule
    ((8, 256, 64), {"data": 2, "model": 2}, (("pod", "data"), "model", None),
     ("data", "model", None)),
    ((8, 256, 64), {"pod": 2, "data": 2, "model": 2},
     (("pod", "data"), "model", None), (("pod", "data"), "model", None)),
    ((3, 255, 64), {"data": 2, "model": 2}, (("pod", "data"), "model", None),
     (None, None, None)),
    ((8, 16, 4, 32), {"data": 1, "model": 2},
     (("pod", "data"), None, "model", None), (None, None, "model", None)),
    ((8, 16, 96), {"data": 2, "model": 1}, (("pod", "data"), None, "model"),
     ("data", None, None)),
    ((4, 16), {"data": 2}, ("pod", "expert"), (None, None)),
])
def test_constrain_resolution_by_hand(case):
    shape, mesh_shape, parts, want = case
    assert tuple(TC.constraint_spec(shape, mesh_shape, *parts)) == want


def test_constrain_counts_and_returns_the_value():
    mesh = TMesh.make_local_mesh()
    x = torch.ones(2, 4, 8)
    tsh.reset_constrain_counts()
    assert TC.constrain(x, None, ("pod", "data"), None, None) is x
    assert tsh.constrain_counts() == {}
    assert TC.constrain(x, mesh, ("pod", "data"), "model", None) is x
    assert tsh.constrain_counts() == {(None, None, None): 1}


def test_local_mesh_is_a_mesh_of_one():
    mesh = TMesh.make_local_mesh()
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.coords == {"data": 0, "model": 0}
    assert mesh.group("data") is None and mesh.group(("data", "model")) \
        is None
    assert copy.deepcopy(mesh) is mesh
    assert mesh == TMesh.make_local_mesh() and hash(mesh) == hash(
        TMesh.make_local_mesh())
    assert mesh != mesh.replicated_batch()
    assert tsh.mesh_shape_dict(mesh) == {"data": 1, "model": 1}
    assert tsh.dp_axes(MESHES["pod2x16x16"]) == ("pod", "data")
    for multi in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            TMesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="ranks"):
        TMesh.lm_mesh({"data": 1, "model": 2})


def test_named_sharding_local_on_a_mesh_of_one():
    mesh = TMesh.make_local_mesh()
    shards = tsh.named(mesh, TM.param_pspecs(tget("gemma2-2b").reduced(),
                                             mesh.shape))
    flat = leaves(shards, is_leaf=tsh.is_sharding)
    x = torch.randn(4, 6)
    assert all(s.local(x) is x for s in flat)
    assert flat[0].local_shape((4, 6)) == (4, 6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _compare(x32, err=None):
    """The port's compress / decompress against the reference's on the
    same float32 input (and error)."""
    jc, jerr = JCmp.compress(jnp.asarray(x32),
                             None if err is None else jnp.asarray(err))
    tc, terr = TCmp.compress(torch.as_tensor(x32),
                             None if err is None else torch.as_tensor(err))
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    assert tc.q.dtype == torch.int8 and tc.scale.dtype == torch.float32
    assert (tc.n, tc.shape) == (jc.n, jc.shape)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(TCmp.decompress(tc).numpy(),
                               np.asarray(JCmp.decompress(jc)), rtol=0,
                               atol=1e-7)
    return tc, terr


@pytest.mark.parametrize("n,seed,scale", rand_cases(
    20, ("int", 1, 2000), ("int", 0, 10**6), ("float", 0.01, 100.0),
    seed=16))
def test_compression_matches_reference(n, seed, scale):
    """Bit for bit against the reference, then its three properties: the
    round trip within max|x| / 127 with the error the exact residual; the
    accumulated error-fed signal within two quantisation steps of the true
    one; a tree's wire bytes the reference's, under a third of float32's."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    comp, err = _compare(x)
    deq = TCmp.decompress(comp).numpy()
    assert deq.shape == x.shape
    bound = float(np.abs(x).max()) / 127.0 + 1e-6
    assert float(np.abs(x - deq).max()) <= bound * 1.01
    np.testing.assert_allclose(err.numpy(), x - deq, rtol=1e-6, atol=1e-7)
    # error feedback over 20 steps of a signal of this case's length
    g = (rng.standard_normal((20, n)) * 0.01 * scale).astype(np.float32)
    e = torch.zeros(n)
    acc_true, acc_deq = np.zeros(n), np.zeros(n)
    for t in range(20):
        if t in (1, 19):           # the error fed back, against the reference
            _compare(g[t], e.numpy())
        c, e = TCmp.compress(torch.as_tensor(g[t]), e)
        acc_true += g[t]
        acc_deq += TCmp.decompress(c).numpy()
    assert np.abs(acc_true - acc_deq).max() <= 2 * np.abs(g).max() / 127.0
    tree = {"a": np.ones((n,), np.float32), "b": {"c": x.reshape(-1, 1)}}
    ttree = {"a": torch.ones(n), "b": {"c": torch.as_tensor(x)[:, None]}}
    wire = TCmp.wire_bytes(ttree)
    assert wire == JCmp.wire_bytes(jax.tree.map(jnp.asarray, tree))
    comp_t, err_t = TCmp.compress_tree(ttree)
    out = TCmp.decompress_tree(comp_t)
    assert [tuple(o.shape) for o in leaves(out)] == [(n,), (n, 1)]
    assert [tuple(o.shape) for o in leaves(err_t)] == [(n,), (n, 1)]
    fixed = {"a": torch.ones(1000), "b": {"c": torch.ones(3, 7)}}
    assert TCmp.wire_bytes(fixed) < sum(l.numel() * 4
                                        for l in leaves(fixed)) / 3
    zeros = TCmp.init_error_tree(ttree)
    assert all(float(z.abs().sum()) == 0 for z in leaves(zeros))


def test_compression_edge_values():
    """Zeros (the 1e-30 floor), exact halves (round half to even), one
    huge value among small ones, a 2-D input, a ragged last block."""
    x = np.zeros(300, np.float32)
    x[:4] = [127.0, 0.5, 1.5, -2.5]
    x[256:260] = [1e30, 1e-30, -3.0, 0.0]
    _compare(x)
    _compare(np.zeros(256, np.float32))
    _compare(np.arange(600, dtype=np.float32).reshape(20, 30) / 7.0)
    assert flatten({"q": 1})[0] == [1]
