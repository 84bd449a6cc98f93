"""The port's kernels against the JAX package's: each plain PyTorch version
(``repro_torch.kernels.ref``, what ``ops`` runs for CPU tensors) against
``repro.kernels.ref`` and against the Pallas kernel in interpret mode, at
ragged shapes with 1e30 poisoned into every masked slot.

Tolerances: float32 throughout; rtol = atol = 1e-5 for the per-row
statistics and the prox (the same per-element formula, only the order of the
row reduction differs), and a per-column bound ``N * eps * sum|x_ij v_i|``
for the GEMV, whose summation order differs.

The whole float32 path through the kernel route (the plain versions on the
CPU) is held against the reference's ``use_pallas=True`` interpret route:
betas 1e-5, on well-conditioned problems (N > p) where both solutions sit
within rounding of the optimum.

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against their plain versions there.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.screen_norms import screen_norms_pallas
from repro.kernels.sgl_prox import sgl_prox_pallas
from repro.kernels.xtv import xtv_pallas
from repro_torch import convert
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.dpc_screen_folds import (borderline_inputs,
                                                  dpc_screen_folds_cuda)
from repro_torch.kernels.screen_norms import screen_norms_cuda
from repro_torch.kernels.screen_norms_folds import screen_norms_folds_cuda
from repro_torch.kernels.sgl_prox import sgl_prox_cuda
from repro_torch.kernels.xtv import xtv_cuda

POISON = 1e30
F32_TOL = dict(rtol=1e-5, atol=1e-5)
EPS32 = float(np.finfo(np.float32).eps)


def _xtv_bound(X, v):
    """Per-column bound of the float32 GEMV's rounding: N*eps*sum|x v|."""
    return X.shape[0] * EPS32 * (np.abs(X.astype(np.float64))
                                 * np.abs(v.astype(np.float64))[:, None]
                                 ).sum(axis=0)


def _padded(rng, G, n_max, keep=0.7):
    """(values with 1e30 in masked slots, mask) as float32 / bool numpy."""
    c = (rng.standard_normal((G, n_max)) * 2).astype(np.float32)
    mask = rng.random((G, n_max)) < keep
    mask[:, 0] = True
    return np.where(mask, c, POISON).astype(np.float32), mask


@pytest.mark.parametrize("N,p", [(1, 1), (7, 13), (33, 300), (250, 517)])
def test_xtv_plain_matches_reference(N, p):
    rng = np.random.default_rng(N * 1000 + p)
    X = rng.standard_normal((N, p)).astype(np.float32)
    v = rng.standard_normal(N).astype(np.float32)
    got = tref.xtv_ref(torch.from_numpy(X), torch.from_numpy(v)).numpy()
    bound = _xtv_bound(X, v) + 1e-30
    for want in (np.asarray(jref.xtv_ref(jnp.asarray(X), jnp.asarray(v))),
                 np.asarray(xtv_pallas(jnp.asarray(X), jnp.asarray(v),
                                       block_n=64, block_p=128,
                                       interpret=True))):
        assert got.dtype == np.float32 and got.shape == (p,)
        assert np.all(np.abs(got - want) <= 2 * bound)


@pytest.mark.parametrize("L,G,n_max", [(1, 1, 1), (3, 5, 17), (4, 37, 9),
                                       (2, 100, 64)])
def test_screen_norms_plain_matches_reference(L, G, n_max):
    rng = np.random.default_rng(L * G * n_max)
    c = np.stack([_padded(rng, G, n_max)[0] for _ in range(L)])
    mask = rng.random((G, n_max)) < 0.7
    mask[:, 0] = True
    c = np.where(mask[None], c, POISON).astype(np.float32)
    # the padded grid as C (L, G*n_max + 1) read through pad_index, every
    # masked slot pointing at the last column, which holds 1e30
    C = np.concatenate([c.reshape(L, G * n_max),
                        np.full((L, 1), POISON, np.float32)], axis=1)
    idx = np.where(mask, np.arange(G * n_max).reshape(G, n_max), G * n_max)
    s, i = ops.screen_norms_gather(torch.from_numpy(C), torch.from_numpy(idx),
                                   torch.from_numpy(mask))
    assert s.shape == (L, G) and i.shape == (L, G)
    flat = c.reshape(L * G, n_max)
    mflat = np.broadcast_to(mask[None], (L, G, n_max)).reshape(L * G, n_max)
    for sr, ir in (jref.screen_norms_ref(jnp.asarray(flat),
                                         jnp.asarray(mflat)),
                   screen_norms_pallas(jnp.asarray(flat), jnp.asarray(mflat),
                                       block_g=8, interpret=True)):
        np.testing.assert_allclose(s.numpy().ravel(), np.asarray(sr),
                                   **F32_TOL)
        np.testing.assert_allclose(i.numpy().ravel(), np.asarray(ir),
                                   **F32_TOL)


def _ragged_poisoned_spec(rng, G, n_max):
    """A ragged spec (some groups of size 0 when n_max = 1) whose masked
    slots point at two extra columns, p (1e30) and p + 1 (NaN).  Returns
    (jspec, pad_index, pad_mask, p) with numpy index and mask."""
    lo = 0 if n_max == 1 else 1
    sizes = rng.integers(lo, n_max + 1, size=G)
    sizes[0] = n_max
    p = int(sizes.sum())
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    mask = np.arange(n_max)[None, :] < sizes[:, None]
    poison = p + (np.arange(G * n_max).reshape(G, n_max) % 2)
    idx = np.where(mask, starts[:, None] + np.arange(n_max)[None, :], poison)
    assert (~mask).any()
    children = [sizes.astype(np.int32), starts.astype(np.int32),
                np.repeat(np.arange(G), sizes).astype(np.int32),
                np.sqrt(sizes.astype(np.float64)), idx.astype(np.int32),
                mask, None]
    jspec = J.GroupSpec.tree_unflatten((G, p, n_max, False), children)
    return jspec, idx.astype(np.int64), mask, p


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("n_max", [1, 9, 10, 17, 64])
def test_screen_norms_gather_plain_matches_reference(L, n_max):
    """The fused plain version (gather by ``pad_index``, then the padded
    statistics) against the reference's ``_grid_group_stats`` kernel route
    (its gather and the Pallas kernel in interpret mode) and against
    ``jref.screen_norms_ref`` on the gathered layout; every masked slot
    points at a 1e30 or a NaN column."""
    from repro.core import screening as jscreen
    rng = np.random.default_rng(100 * L + n_max)
    G = 23
    jspec, idx, mask, p = _ragged_poisoned_spec(rng, G, n_max)
    C = (rng.standard_normal((L, p + 2)) * 2).astype(np.float32)
    C[:, p], C[:, p + 1] = POISON, np.nan
    s, i = tref.screen_norms_gather_ref(torch.from_numpy(C),
                                        torch.from_numpy(idx),
                                        torch.from_numpy(mask))
    assert s.shape == (L, G) and i.shape == (L, G)
    assert s.dtype == i.dtype == torch.float32
    assert bool(torch.isfinite(s).all() and torch.isfinite(i).all())
    jn, ji = jscreen._grid_group_stats(jspec, jnp.asarray(C), True)
    np.testing.assert_allclose(np.sqrt(s.numpy()), np.asarray(jn), **F32_TOL)
    np.testing.assert_allclose(i.numpy(), np.asarray(ji), **F32_TOL)
    flat = np.where(mask[None], C[:, idx], 0.0).reshape(L * G, n_max)
    mflat = np.broadcast_to(mask[None], (L, G, n_max)).reshape(L * G, n_max)
    sr, ir = jref.screen_norms_ref(jnp.asarray(flat), jnp.asarray(mflat))
    np.testing.assert_allclose(s.numpy().ravel(), np.asarray(sr), **F32_TOL)
    np.testing.assert_allclose(i.numpy().ravel(), np.asarray(ir), **F32_TOL)


@pytest.mark.parametrize("G,n_max,t_l1", [(1, 1, 0.0), (5, 17, 0.3),
                                          (37, 9, 1.1), (64, 130, 0.05)])
def test_sgl_prox_plain_matches_reference(G, n_max, t_l1):
    """The padded oracle ``sgl_prox_ref``, on which the flat plain version
    is built, against the reference's oracle and Pallas kernel."""
    rng = np.random.default_rng(G * n_max)
    v, mask = _padded(rng, G, n_max)
    t_group = (rng.random(G) * 3).astype(np.float32)
    got = tref.sgl_prox_ref(torch.from_numpy(v), torch.from_numpy(mask),
                            torch.tensor([t_l1], dtype=torch.float32),
                            torch.from_numpy(t_group)).numpy()
    assert np.all(got[~mask] == 0.0)
    for want in (jref.sgl_prox_ref(jnp.asarray(v), jnp.asarray(mask),
                                   jnp.float32(t_l1), jnp.asarray(t_group)),
                 sgl_prox_pallas(jnp.asarray(v), jnp.asarray(mask), t_l1,
                                 jnp.asarray(t_group), block_g=8,
                                 interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def _bucketed_specs(sizes, keep, p_b, g_b, seed):
    """A ragged bucketed spec whose garbage bin runs past n_max, so some
    columns no valid slot covers, as the reference's spec and the port's.
    Every masked slot points at an uncovered column.  Returns (jspec,
    tspec, uncovered columns)."""
    full = J.GroupSpec.from_sizes(sizes)
    gid = np.repeat(np.arange(len(sizes)), sizes)
    sub, _ = full.bucketed_subset(np.isin(gid, keep), p_b, g_b)
    leaves, aux = sub.tree_flatten()
    ch = dict(zip(convert.SPEC_FIELDS, (None if a is None else np.asarray(a)
                                        for a in leaves)))
    mask = ch["pad_mask"]
    uncovered = np.setdiff1d(np.arange(p_b), ch["pad_index"][mask])
    assert uncovered.size > 0
    idx = ch["pad_index"].copy()
    idx[~mask] = np.random.default_rng(seed).choice(uncovered,
                                                    int((~mask).sum()))
    ch["pad_index"] = idx
    jspec = J.GroupSpec.tree_unflatten(
        aux, [ch[f] for f in convert.SPEC_FIELDS])
    return jspec, convert.group_spec(ch, device="cpu"), uncovered


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("sizes,keep,p_b,g_b", [
    ([3, 7, 1, 9, 5, 2, 8, 4], [1, 3, 6], 64, 8),     # ragged, bin of 40
    ([10] * 40, [0, 5, 17, 33], 128, 16),              # uniform, bin of 88
    ([1] * 50, [2, 9, 30], 16, 8),                     # n_max = 1
    ([40, 35, 7, 50], [0, 3], 256, 4),                 # n_max > 32
])
def test_sgl_prox_flat_plain_matches_reference_padded_prox(
        sizes, keep, p_b, g_b, dtype, atol):
    """The flat plain prox (what the CPU runs in the kernel's place)
    against the reference's ``path_engine._padded_prox`` (gather, Pallas
    kernel in interpret mode, scatter-add), with 1e30 in every column no
    valid slot covers and every masked slot pointing at one: those columns
    come out exactly 0."""
    from repro.core.path_engine import _padded_prox as j_padded_prox
    jspec, tspec, uncovered = _bucketed_specs(sizes, keep, p_b, g_b,
                                              seed=p_b + g_b)
    assert bool(tspec.pad_uncovered[uncovered].all())
    assert int(tspec.pad_uncovered.sum()) == uncovered.size
    rng = np.random.default_rng(len(sizes))
    v = (rng.standard_normal(p_b) * 2).astype(dtype)
    v[uncovered] = POISON
    t_l1 = dtype(0.3)
    t_group = (rng.random(g_b) * 2).astype(dtype)
    got = ops.sgl_prox(torch.from_numpy(v), tspec.pad_index, tspec.pad_mask,
                       tspec.pad_uncovered, torch.tensor([t_l1]),
                       torch.from_numpy(t_group)).numpy()
    want = np.asarray(j_padded_prox(jspec)(jnp.asarray(v), jnp.asarray(t_l1),
                                           jnp.asarray(t_group)))
    assert got.dtype == dtype and got.shape == (p_b,)
    assert np.all(got[uncovered] == 0.0)
    assert np.count_nonzero(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("K,L,G,n_max", [(1, 1, 1, 1), (3, 4, 37, 9),
                                         (2, 8, 100, 10), (3, 2, 5, 40)])
def test_screen_norms_folds_plain_matches_reference(K, L, G, n_max):
    """Against ``ops.screen_norms_folds`` (the Pallas kernel, interpret)
    and the vmapped ``screen_norms_ref`` oracle of
    ``analysis/pallas_check.py``, 1e30 in every masked slot."""
    rng = np.random.default_rng(K * L * G * n_max + 1)
    mask = rng.random((G, n_max)) < 0.7
    mask[:, 0] = True
    c = (rng.standard_normal((K, L, G, n_max)) * 2).astype(np.float32)
    c = np.where(mask, c, POISON).astype(np.float32)
    s, i = ops.screen_norms_folds(torch.from_numpy(c), torch.from_numpy(mask))
    assert s.shape == (K, L, G) and i.shape == (K, L, G)
    oracle = jax.vmap(jax.vmap(jax.vmap(
        lambda row: jref.screen_norms_ref(row, jnp.asarray(mask)))))
    for sr, ir in (jops.screen_norms_folds(jnp.asarray(c), jnp.asarray(mask),
                                           interpret=True),
                   oracle(jnp.asarray(c)[:, :, None])):
        np.testing.assert_allclose(s.numpy(), np.asarray(sr).reshape(K, L, G),
                                   **F32_TOL)
        np.testing.assert_allclose(i.numpy(), np.asarray(ir).reshape(K, L, G),
                                   **F32_TOL)


@pytest.mark.parametrize("K,L,p", [(1, 1, 1), (3, 9, 517), (2, 16, 1030)])
def test_dpc_screen_folds_plain_matches_reference_exactly(K, L, p):
    """Against ``ops.dpc_screen_folds`` (the Pallas kernel, interpret) and
    the plain rule of ``analysis/pallas_check.py``, at atol = 0."""
    rng = np.random.default_rng(K * L * p)
    C = (rng.standard_normal((K, L, p)) * 0.5 + 0.6).astype(np.float32)
    radii = rng.random((K, L)).astype(np.float32)
    cn = (rng.random((K, p)) + 0.5).astype(np.float32)
    got = ops.dpc_screen_folds(torch.from_numpy(C), torch.from_numpy(radii),
                               torch.from_numpy(cn)).numpy()
    assert got.dtype == bool and got.shape == (K, L, p)
    want_k = np.asarray(jops.dpc_screen_folds(
        jnp.asarray(C), jnp.asarray(radii), jnp.asarray(cn), interpret=True))
    want_r = np.asarray((jnp.asarray(C) + jnp.asarray(radii)[:, :, None]
                         * jnp.asarray(cn)[:, None, :]) >= 1.0)
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(got, want_r)


def test_dpc_screen_folds_plain_rounds_product_and_sum_apart():
    """On inputs that land on 1.0 within one ulp, the plain version is the
    two-rounding ``fl(C + fl(r * cn)) >= 1`` that the CUDA kernel keeps,
    and a fused multiply-add would flip some decisions."""
    C, r, cn, n_flips = borderline_inputs(2, 8, 513, seed=3)
    assert n_flips > 0
    got = ops.dpc_screen_folds(torch.from_numpy(C), torch.from_numpy(r),
                               torch.from_numpy(cn)).numpy()
    want = (C + r[:, :, None] * cn[:, None, :]) >= np.float32(1.0)
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < got.size


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    X = torch.randn(5, 7)
    ops.xtv(X, torch.randn(5))
    ops.screen_norms_gather(torch.randn(2, 12), torch.arange(12).reshape(3, 4),
                            torch.ones(3, 4, dtype=torch.bool))
    ops.sgl_prox(torch.randn(12), torch.arange(12).reshape(3, 4),
                 torch.ones(3, 4, dtype=torch.bool),
                 torch.zeros(12, dtype=torch.bool), torch.tensor([0.1]),
                 torch.rand(3))
    ops.screen_norms_folds(torch.randn(2, 2, 3, 4),
                           torch.ones(3, 4, dtype=torch.bool))
    ops.dpc_screen_folds(torch.randn(2, 3, 7), torch.rand(2, 3),
                         torch.rand(2, 7))
    assert ops.launch_counts() == {"xtv": 0, "screen_norms": 0,
                                   "sgl_prox": 0, "screen_norms_folds": 0,
                                   "dpc_screen_folds": 0}


@pytest.mark.parametrize("launch,args", [
    (xtv_cuda, (torch.zeros(3, 4), torch.zeros(3))),
    (screen_norms_cuda, (torch.zeros(6, 12), torch.arange(12).reshape(3, 4),
                         torch.ones(3, 4, dtype=torch.bool))),
    (sgl_prox_cuda, (torch.zeros(12), torch.arange(12).reshape(3, 4),
                     torch.ones(3, 4, dtype=torch.bool),
                     torch.zeros(12, dtype=torch.bool), torch.zeros(1),
                     torch.zeros(3))),
    (screen_norms_folds_cuda, (torch.zeros(2, 3, 4),
                               torch.ones(3, 4, dtype=torch.bool))),
    (dpc_screen_folds_cuda, (torch.zeros(2, 3, 5), torch.zeros(2, 3),
                             torch.zeros(2, 5))),
])
def test_kernel_launchers_refuse_cpu_tensors(launch, args):
    with pytest.raises(ValueError, match="CUDA"):
        launch(*args)


def test_build_covers_every_source_with_a_signature():
    names = sorted(s.stem for s in build.sources())
    assert names == ["dpc_screen_folds", "screen_norms",
                     "screen_norms_folds", "sgl_prox", "xtv"]
    assert sorted(build.SIGNATURES) == sorted(
        f"repro_{n}_f32" for n in names)
    assert len(build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("N,G,n", [(120, 12, 5), (200, 10, 6)])
def test_path_f32_kernel_route_matches_reference_pallas_route(N, G, n):
    rng = np.random.default_rng(N)
    X = rng.standard_normal((N, G * n))
    beta = np.zeros(G * n)
    beta[:2] = rng.standard_normal(2)
    beta[n:n + 2] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    X, y = X.astype(np.float32), y.astype(np.float32)
    kw = dict(alpha=0.9, n_lambdas=10, min_ratio=0.05, tol=1e-6,
              safety=1e-4, max_iter=20000, check_every=10, min_bucket=32)
    jspec = J.GroupSpec.from_sizes([n] * G)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(
        J.Plan(**kw, use_pallas=True))
    children = {f: (None if getattr(jspec, f) is None
                    else np.asarray(getattr(jspec, f)))
                for f in convert.SPEC_FIELDS}
    rt = T.SGLSession(convert.problem(X, y, children, device="cpu")).path(
        T.Plan(**kw, use_kernels=True))
    np.testing.assert_allclose(rt.betas, rj.betas, atol=1e-5)
    assert rt.stats.n_pallas_screens == rt.stats.n_screens > 0


# ---------------------------------------------------------------------------
# the reference's padded-layout entry points: ops.screen_norms,
# ops.screen_norms_batched, ops.sgl_prox_padded
# ---------------------------------------------------------------------------

def _nan_poisoned(c, mask):
    """``c`` (1e30 in its masked slots) with NaN in every other masked
    slot, so both poisons reach the entry point."""
    out = c.copy()
    alt = (np.arange(c.size).reshape(c.shape) % 2 == 1)
    out[~mask & alt] = np.nan
    return out


@pytest.mark.parametrize("G,n_max", [(1, 1), (5, 17), (37, 9), (100, 64)])
def test_padded_screen_norms_matches_reference_ops(G, n_max):
    """``ops.screen_norms(c_pad, mask)`` against the reference's
    ``ops.screen_norms`` in interpret mode, 1e30 and NaN in the masked
    slots: (G,) float32, ``cinf`` exactly."""
    rng = np.random.default_rng(11 * G + n_max)
    c, mask = _padded(rng, G, n_max)
    c = _nan_poisoned(c, mask)
    s, i = ops.screen_norms(torch.from_numpy(c), torch.from_numpy(mask))
    sj, ij = jops.screen_norms(jnp.asarray(c), jnp.asarray(mask),
                               interpret=True)
    assert s.shape == i.shape == (G,)
    assert s.dtype == i.dtype == torch.float32
    assert bool(torch.isfinite(s).all() and torch.isfinite(i).all())
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **F32_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


@pytest.mark.parametrize("sizes", [(3, 7, 1, 5, 4, 9, 2, 6), (1,) * 9,
                                   (12, 1, 33, 2)])
def test_padded_screen_norms_batched_grid_layout(sizes):
    """The (L, G, n_max) grid layout of ``tests/test_kernels.py:162``: a
    ragged spec's padded view scaled by L factors, garbage in the padded
    lanes, against the reference's ``ops.screen_norms_batched`` in
    interpret mode and against its oracle on the clean rows."""
    rng = np.random.default_rng(sum(sizes))
    mask = T.GroupSpec.from_sizes(list(sizes), device="cpu").pad_mask.numpy()
    G, n_max = mask.shape
    clean = np.where(mask, rng.standard_normal((G, n_max)) * 2,
                     0.0).astype(np.float32)
    dirty = _nan_poisoned(np.where(mask, clean, POISON).astype(np.float32),
                          mask)
    L = 5
    scales = rng.uniform(0.2, 3.0, L).astype(np.float32)
    grid = scales[:, None, None] * dirty[None]
    s, i = ops.screen_norms_batched(torch.from_numpy(grid),
                                    torch.from_numpy(mask))
    assert s.shape == i.shape == (L, G)
    assert s.dtype == i.dtype == torch.float32
    sj, ij = jops.screen_norms_batched(jnp.asarray(grid), jnp.asarray(mask),
                                       interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **F32_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    for r in range(L):
        sr, ir = jref.screen_norms_ref(jnp.asarray(scales[r] * clean),
                                       jnp.asarray(mask))
        np.testing.assert_allclose(s[r].numpy(), np.asarray(sr), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(i[r].numpy(), np.asarray(ir), rtol=1e-5)


@pytest.mark.parametrize("G,n_max,t_l1", [(1, 1, 0.0), (5, 17, 0.3),
                                          (37, 9, 1.1), (64, 130, 0.05)])
def test_padded_sgl_prox_matches_reference_ops(G, n_max, t_l1):
    """``ops.sgl_prox_padded`` against the reference's
    ``ops.sgl_prox_padded`` in interpret mode, 1e30 and NaN in the masked
    slots, which come out exactly 0."""
    rng = np.random.default_rng(13 * G + n_max)
    v, mask = _padded(rng, G, n_max)
    v = _nan_poisoned(v, mask)
    t_group = (rng.random(G) * 3).astype(np.float32)
    got = ops.sgl_prox_padded(torch.from_numpy(v), torch.from_numpy(mask),
                              t_l1, torch.from_numpy(t_group))
    assert got.shape == (G, n_max) and got.dtype == torch.float32
    assert np.all(got.numpy()[~mask] == 0.0)
    want = jops.sgl_prox_padded(jnp.asarray(v), jnp.asarray(mask),
                                jnp.float32(t_l1), jnp.asarray(t_group),
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_padded_entry_points_count_under_their_kernels():
    """On the CPU the padded entry points take the plain versions and
    launch nothing; under a dispatch mode each is one call of its kernel's
    operator, under the kernel's name."""
    from repro_torch.launch.cost_analysis import CostCounter
    mask = torch.ones(3, 4, dtype=torch.bool)
    mask[1, 2:] = False
    calls = (lambda: ops.screen_norms(torch.randn(3, 4), mask),
             lambda: ops.screen_norms_batched(torch.randn(2, 3, 4), mask),
             lambda: ops.sgl_prox_padded(torch.randn(3, 4), mask, 0.1,
                                         torch.rand(3)))
    ops.reset_launch_counts()
    for call in calls:
        call()
    assert set(ops.launch_counts().values()) == {0}
    with CostCounter(memory=False) as c:
        for call in calls:
            call()
    assert dict(c.kernel_calls) == {"screen_norms": 2, "sgl_prox": 1}


MISMATCHED = {   # each entry point on an input whose (G, n_max) is not mask's
    "screen_norms": lambda m, c: ops.screen_norms(c, m),
    "screen_norms_batched": lambda m, c: ops.screen_norms_batched(c[None], m),
    "sgl_prox_padded": lambda m, c: ops.sgl_prox_padded(
        c, m, 0.1, torch.ones(c.shape[0])),
}


@pytest.mark.parametrize("name", sorted(MISMATCHED))
@pytest.mark.parametrize("shape", [(3, 5), (4, 4), (2, 4)])
def test_padded_entry_points_refuse_a_mask_of_another_shape(name, shape):
    """A mask larger or smaller than the padded input raises before any
    kernel or plain version runs (the kernel trusts every valid slot to
    lie inside the input)."""
    mask = torch.ones(3, 4, dtype=torch.bool)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="mask"):
        MISMATCHED[name](mask, torch.randn(*shape))
    assert set(ops.launch_counts().values()) == {0}
