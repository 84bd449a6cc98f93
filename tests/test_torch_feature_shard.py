"""The port's feature sharding (``repro_torch.distributed.feature_shard``,
the ``_feat`` grid screens and ``Plan(feature_shards=S)``) against the live
JAX reference on the same numpy problems, through the stacked executor
(one process holds every block; ``tests/test_torch_feature_dist.py`` runs
the ranks).

1. The partition: ``effective_shards``, the block layout and every local
   spec equal the reference's; the layout shuttles round-trip.
2. The sharded primitives and each ``_feat`` screen against the
   reference's on the same blocks: keep masks equal, numbers within
   1e-12, the dual scaling of ``cert_sgl`` / ``cert_nn`` bit for bit.
   ``group_sum`` on a block with pad columns.
3. Paths in float64 at ``tol=1e-13``: port sharded against reference
   sharded (betas within 1e-8, kept sets and counters equal; total FISTA
   iterations within 10%, as in ``tests/test_torch_path.py``: the power
   method starts from numpy, not ``jax.random``), and port sharded against
   port unsharded within 1e-12 (the reference's ``BETA_ATOL``).
4. Fold paths under the lockstep schedule, ``refine`` and ``stability``.
   Every unscreened fold case has more training rows than features
   (ROADMAP queue 3, "underdetermined problems").
5. The refusals.
"""
import numpy as np
import pytest
import torch
from conftest import rand_cases

import jax.numpy as jnp
import repro.core as J
import repro_torch.core as T
from repro.core import cv as jcv
from repro.core import dpc as jdpc
from repro.core import screening as jscr
from repro.distributed import feature_shard as jfs
from repro_torch import convert
from repro_torch.core import cv as tcv
from repro_torch.core import dpc as tdpc
from repro_torch.core import path_engine as tpe
from repro_torch.core import screening as tscr
from repro_torch.core.groups import group_sum
from repro_torch.core.linalg import spectral_norm
from repro_torch.distributed import feature_shard as tfs

RAGGED = (7, 11, 5, 13, 9, 8, 17, 6, 12, 8)   # 10 groups: 8 shards -> 5
PATH_KW = dict(n_lambdas=12, min_ratio=0.05, tol=1e-13, safety=1e-6,
               max_iter=200_000)


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


def _specs(sizes):
    jspec = J.GroupSpec.from_sizes(list(sizes))
    return jspec, convert.group_spec(_children(jspec), device="cpu")


def sgl_problem(seed=3, N=40, sizes=(6,) * 16):
    """``tests/test_feature_shard.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    jspec = J.GroupSpec.from_sizes(list(sizes))
    p = int(np.sum(sizes))
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(len(sizes), 3, replace=False):
        s0 = int(np.asarray(jspec.starts)[g])
        w = int(np.asarray(jspec.sizes)[g])
        beta[s0:s0 + max(w // 2, 1)] = rng.standard_normal(max(w // 2, 1))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, sizes


def nn_problem(seed=4, N=40, p=96):
    """``tests/test_feature_shard.py:_nn_problem``."""
    rng = np.random.default_rng(seed)
    X = np.abs(rng.standard_normal((N, p)))
    beta = np.zeros(p)
    beta[rng.choice(p, 8, replace=False)] = np.abs(rng.standard_normal(8))
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


def fold_masks(N, K, seed=0):
    """``tests/test_feature_shard.py:_fold_masks``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    masks = np.zeros((K, N))
    for k in range(K):
        masks[k, np.setdiff1d(perm, perm[k::K])] = 1.0
    return masks


def _stats(st):
    return (st.n_segments, st.n_screens, st.n_compilations, st.n_rejected,
            st.n_pallas_screens, [tuple(b) for b in st.buckets])


# ---------------------------------------------------------------------------
# 1. The partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_units,requested", rand_cases(
    12, ("int", 1, 96), ("int", 1, 12), seed=21))
def test_effective_shards_matches_reference(n_units, requested):
    got = tfs.effective_shards(n_units, requested)
    assert got == jfs.effective_shards(n_units, requested)
    assert n_units % got == 0


@pytest.mark.parametrize("seed,requested", rand_cases(
    8, ("int", 0, 10**6), ("int", 2, 9), seed=22))
def test_partition_and_local_specs_match_reference(seed, requested):
    """Block starts, widths, ``p_shard`` and every leaf of every local
    spec equal the reference's ``specs_stacked``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 14, size=int(rng.integers(4, 24))).tolist()
    jspec, tspec = _specs(sizes)
    p = int(sum(sizes))
    fj = jfs.plan_feature_shards(requested, p, jspec)
    ft = tfs.plan_feature_shards(requested, p, tspec)
    assert (ft.n_shards, ft.p_shard, ft.units_per_shard, ft.n_units) == \
        (fj.n_shards, fj.p_shard, fj.units_per_shard, fj.n_units)
    np.testing.assert_array_equal(ft.col_starts, fj.col_starts)
    np.testing.assert_array_equal(ft.widths, fj.widths)
    np.testing.assert_array_equal(ft.col_mask, fj.col_mask)
    assert len(ft.specs) == ft.n_shards
    for s, loc in enumerate(ft.specs):
        for f in ("sizes", "starts", "group_ids", "weights", "pad_index",
                  "pad_mask"):
            np.testing.assert_array_equal(
                getattr(loc, f).numpy(),
                np.asarray(getattr(fj.specs_stacked, f))[s])
        assert (loc.num_groups, loc.num_features, loc.max_size,
                loc.uniform) == (fj.specs_stacked.num_groups,
                                 fj.specs_stacked.num_features,
                                 fj.specs_stacked.max_size,
                                 fj.specs_stacked.uniform)
        # the segment sums run the last group over the block's pad columns
        assert int(loc.seg_lengths.sum()) == ft.p_shard


@pytest.mark.parametrize("seed,requested", rand_cases(
    6, ("int", 0, 10**6), ("int", 2, 9), seed=23))
def test_layout_shuttles_roundtrip(seed, requested):
    """The host shuttles and the executor's device scatter / gather are
    exact inverses on the real columns; pads stay zero."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 10, size=12).tolist()
    _, tspec = _specs(sizes)
    p = int(sum(sizes))
    fp = tfs.plan_feature_shards(requested, p, tspec)
    X = rng.standard_normal((7, p))
    v = rng.standard_normal(p)
    g = rng.standard_normal(len(sizes))
    np.testing.assert_array_equal(fp.unshard_features(fp.stack_columns(X)),
                                  X)
    np.testing.assert_array_equal(fp.unshard_features(fp.shard_features(v)),
                                  v)
    np.testing.assert_array_equal(fp.unshard_groups(fp.shard_groups(g)), g)
    assert np.all(fp.stack_columns(X) * ~fp.col_mask[:, None, :] == 0.0)
    ops = tfs.feature_ops(fp.n_shards)
    tfs.reset_collective_counts()
    blocks = ops.blocks(fp, torch.as_tensor(X))
    np.testing.assert_array_equal(torch.stack(blocks).numpy(),
                                  fp.stack_columns(X))
    v_s = ops.scatter(fp, torch.as_tensor(v))
    np.testing.assert_array_equal(v_s.numpy(), fp.shard_features(v))
    np.testing.assert_array_equal(fp.unshard_features(ops.gather(v_s)), v)
    np.testing.assert_array_equal(
        ops.scatter_groups(fp, torch.as_tensor(g)).numpy(),
        fp.shard_groups(g))
    assert tfs.collective_counts() == dict.fromkeys(tfs.COLLECTIVES, 0)


@pytest.mark.parametrize("seed,requested", rand_cases(
    6, ("int", 0, 10**6), ("int", 2, 9), seed=24))
def test_shard_width_bound_is_an_envelope(seed, requested):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 11, size=18).tolist()
    _, tspec = _specs(sizes)
    p = int(sum(sizes))
    fp = tfs.plan_feature_shards(requested, p, tspec)
    bound = tfs.shard_width_bound(p, 18, fp.n_shards, int(max(sizes)))
    assert fp.p_shard <= bound == jfs.shard_width_bound(
        p, 18, fp.n_shards, int(max(sizes)))


def test_degenerate_partitions():
    """A prime group count, ``requested = 1`` and more shards than
    columns, as in the reference."""
    _, tspec = _specs([4] * 13)
    assert tfs.plan_feature_shards(8, 52, tspec).n_shards == 1
    assert tfs.plan_feature_shards(1, 52, tspec).n_shards == 1
    fp_nn = tfs.plan_feature_shards(97, 96, None)
    assert fp_nn.n_shards == 96 and fp_nn.specs is None


# ---------------------------------------------------------------------------
# 2. The sharded primitives and the _feat screens, block for block
# ---------------------------------------------------------------------------

def _blocks(sizes, N=30, seed=11, requested=8):
    """One problem in both packages' sharded layouts: (fj, jops, Xs_j,
    ft, tops, Xs_t, X, tspec, jspec)."""
    rng = np.random.default_rng(seed)
    jspec, tspec = _specs(sizes)
    p = int(sum(sizes))
    X = rng.standard_normal((N, p))
    fj = jfs.plan_feature_shards(requested, p, jspec)
    ft = tfs.plan_feature_shards(requested, p, tspec)
    tops = tfs.feature_ops(ft.n_shards)
    return (fj, jfs.feature_ops(fj.n_shards, None),
            jnp.asarray(fj.stack_columns(X)), ft, tops,
            tops.blocks(ft, torch.as_tensor(X)), X, tspec, jspec)


@pytest.mark.parametrize("sizes", [(6,) * 16, RAGGED])
def test_sharded_primitives_match_reference(sizes):
    fj, jops, Xj, ft, tops, Xt, X, tspec, jspec = _blocks(sizes)
    tfs.reset_collective_counts()
    rng = np.random.default_rng(1)
    v = rng.standard_normal(X.shape[0])
    b = rng.standard_normal(X.shape[1])
    close = dict(rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tfs.sharded_xtv(tops, Xt, torch.as_tensor(v)).numpy(),
        np.asarray(jfs.sharded_xtv(jops, Xj, jnp.asarray(v))), **close)
    fit = tfs.sharded_fit(tops, Xt, tops.scatter(ft, torch.as_tensor(b)))
    np.testing.assert_allclose(fit.numpy(), X @ b, **close)
    B = rng.standard_normal((3, X.shape[1]))
    fitK = tfs.sharded_fit(tops, Xt, tops.scatter(ft, torch.as_tensor(B)))
    np.testing.assert_allclose(fitK.numpy(), B @ X.T, **close)
    np.testing.assert_allclose(
        tfs.sharded_column_norms(tops, Xt).numpy(),
        np.asarray(jfs.sharded_column_norms(jops, Xj)), **close)
    specs = tops.local(ft.specs)
    np.testing.assert_allclose(
        tfs.sharded_group_spectral_norms(tops, Xt, specs).numpy(),
        np.asarray(jfs.sharded_group_spectral_norms(jops, Xj,
                                                    fj.specs_stacked)),
        rtol=1e-10)
    np.testing.assert_allclose(
        tfs.sharded_group_frobenius_norms(tops, Xt, specs).numpy(),
        np.asarray(jfs.sharded_group_frobenius_norms(jops, Xj,
                                                     fj.specs_stacked)),
        **close)
    # the power method from linalg.spectral_norm's start vector: the
    # unsharded estimate to rounding; like the reference's (another start
    # vector), a lower bound within 50 steps' convergence of ||X||_2
    s_sh = float(tfs.sharded_spectral_norm(tops, ft, Xt))
    s_full = float(spectral_norm(torch.as_tensor(X)))
    assert abs(s_sh - s_full) <= 1e-12 * s_full
    s_true = float(np.linalg.norm(X, 2))
    s_ref = float(jfs.sharded_spectral_norm(jops, Xj,
                                            jnp.asarray(fj.col_mask)))
    for est in (s_sh, s_ref):
        assert s_true * (1 - 1e-3) <= est <= s_true * (1 + 1e-12)
    assert tfs.collective_counts() == dict.fromkeys(tfs.COLLECTIVES, 0)


@pytest.mark.parametrize("sizes", [(6,) * 16, RAGGED])
def test_certificates_match_reference(sizes):
    """``cert_sgl`` / ``cert_nn``: the stacked correlations within 1e-12,
    the dual scaling bit for bit (a min / max of the same numbers)."""
    fj, jops, Xj, ft, tops, Xt, X, tspec, jspec = _blocks(sizes)
    rho = np.random.default_rng(2).standard_normal(X.shape[0]) * 0.3
    c_t, s_t = tfs.cert_sgl(tops, Xt, tops.local(ft.specs),
                            torch.as_tensor(rho), 0.5)
    c_j, s_j = jfs.cert_sgl(jops, Xj, fj.specs_stacked, jnp.asarray(rho),
                            0.5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-12)
    assert float(s_t) == float(s_j) < 1.0
    # and the unsharded scaling of the same correlations
    c_full = torch.as_tensor(ft.unshard_features(c_t.numpy()))
    assert float(s_t) == float(T.dual_scaling_sgl(tspec, c_full, 0.5))
    c_t, s_t = tfs.cert_nn(tops, Xt, torch.as_tensor(rho))
    c_j, s_j = jfs.cert_nn(jops, Xj, jnp.asarray(rho))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=1e-12)
    assert float(s_t) == float(s_j) < 1.0


def _screen_inputs(X, seed=3, L=6):
    rng = np.random.default_rng(seed)
    N = X.shape[0]
    y = X[:, :4] @ rng.standard_normal(4) + 0.1 * rng.standard_normal(N)
    lam_max = float(np.abs(X.T @ y).max())
    lambdas = lam_max * np.geomspace(0.9, 0.2, L)
    theta = y / lam_max * 0.98
    n_vec = rng.standard_normal(N)
    return y, lambdas, theta, n_vec


@pytest.mark.parametrize("sizes", [(6,) * 16, RAGGED])
def test_sgl_feat_screens_match_reference(sizes):
    """TLFre and Gap-Safe grid screens, path and fold forms (with and
    without centering): keep masks equal, radii within 1e-12."""
    fj, jops, Xj, ft, tops, Xt, X, tspec, jspec = _blocks(sizes)
    y, lambdas, theta, n_vec = _screen_inputs(X)
    N, p = X.shape
    cn_j = jfs.sharded_column_norms(jops, Xj)
    gs_j = jfs.sharded_group_spectral_norms(jops, Xj, fj.specs_stacked)
    cn_t = tfs.sharded_column_norms(tops, Xt)
    gs_t = tfs.sharded_group_spectral_norms(tops, Xt, tops.local(ft.specs))
    specs_t = tops.local(ft.specs)
    t = torch.as_tensor
    gk_j, fk_j, r_j = jscr.tlfre_screen_grid_feat(
        jops, Xj, fj.specs_stacked, jnp.asarray(y), 0.5, jnp.asarray(lambdas),
        jnp.asarray(theta), jnp.asarray(n_vec), cn_j, gs_j, safety=1e-6)
    gk_t, fk_t, r_t = tscr.tlfre_screen_grid_feat(
        tops, Xt, specs_t, t(y), 0.5, t(lambdas), t(theta), t(n_vec), cn_t,
        gs_t, safety=1e-6)
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)
    assert 0 < int(fk_t.sum()) < fk_t.numel()
    # the same masks as the unsharded port screen
    _, fk_u, _ = tscr.tlfre_screen_grid(
        t(X), t(y), tspec, 0.5, t(lambdas), None, t(theta), t(n_vec),
        T.column_norms(t(X)), T.group_spectral_norms(t(X), tspec),
        safety=1e-6)
    np.testing.assert_array_equal(ft.unshard_features(fk_t.numpy()),
                                  fk_u.numpy())

    c_theta = X.T @ theta
    c_s = ft.shard_features(c_theta)
    radii = np.linspace(0.05, 0.3, len(lambdas))
    gk_j, fk_j = jscr.gap_safe_screen_grid_feat(
        jops, fj.specs_stacked, 0.5, jnp.asarray(c_s), jnp.asarray(radii),
        cn_j, gs_j)
    gk_t, fk_t = tscr.gap_safe_screen_grid_feat(
        tops, specs_t, 0.5, t(c_s), t(radii), cn_t, gs_t)
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))

    K = 3
    masks = fold_masks(N, K, seed=5)
    Y = masks * y[None, :]
    lams_f = np.stack([lambdas * (1.0 + 0.01 * k) for k in range(K)])
    Theta = masks * theta[None, :]
    N_vecs = masks * n_vec[None, :]
    cn_f = np.sqrt(masks @ (X * X))
    gs_f = np.stack([np.asarray(J.group_spectral_norms(
        jnp.asarray(masks[k][:, None] * X), jspec)) for k in range(K)])
    mus = (masks @ X) / masks.sum(axis=1)[:, None]
    for mu in (None, mus):
        gk_j, fk_j, r_j = jscr.tlfre_screen_grid_folds_feat(
            jops, Xj, fj.specs_stacked, jnp.asarray(Y), 0.5,
            jnp.asarray(lams_f), jnp.asarray(Theta), jnp.asarray(N_vecs),
            jnp.asarray(ft.shard_features(cn_f)),
            jnp.asarray(fj.shard_groups(gs_f)), safety=1e-6,
            mus_s=None if mu is None else jnp.asarray(ft.shard_features(mu)))
        gk_t, fk_t, r_t = tscr.tlfre_screen_grid_folds_feat(
            tops, Xt, specs_t, t(Y), 0.5, t(lams_f), t(Theta), t(N_vecs),
            t(ft.shard_features(cn_f)), t(ft.shard_groups(gs_f)),
            safety=1e-6,
            mus_s=None if mu is None else t(ft.shard_features(mu)))
        np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
        np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)
    c_thetas = ft.shard_features(Theta @ X)
    radii_f = np.stack([radii * (1.0 + 0.1 * k) for k in range(K)])
    gk_j, fk_j = jscr.gap_safe_screen_grid_folds_feat(
        jops, fj.specs_stacked, 0.5, jnp.asarray(c_thetas),
        jnp.asarray(radii_f), jnp.asarray(ft.shard_features(cn_f)),
        jnp.asarray(fj.shard_groups(gs_f)))
    gk_t, fk_t = tscr.gap_safe_screen_grid_folds_feat(
        tops, specs_t, 0.5, t(c_thetas), t(radii_f),
        t(ft.shard_features(cn_f)), t(ft.shard_groups(gs_f)))
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))


def test_dpc_feat_screens_match_reference():
    """The Theorem-22 screens, path and fold forms, and the Gap-Safe DPC
    rule: keep masks equal, radii within 1e-12."""
    X, _ = nn_problem()
    N, p = X.shape
    fj = jfs.plan_feature_shards(8, p, None)
    ft = tfs.plan_feature_shards(8, p, None)
    jops, tops = jfs.feature_ops(fj.n_shards, None), tfs.feature_ops(8)
    Xj = jnp.asarray(fj.stack_columns(X))
    Xt = tops.blocks(ft, torch.as_tensor(X))
    y, lambdas, theta, n_vec = _screen_inputs(X)
    cn = np.linalg.norm(X, axis=0)
    cn_s = ft.shard_features(cn)
    t = torch.as_tensor
    fk_j, r_j = jdpc.dpc_screen_grid_feat(
        jops, Xj, jnp.asarray(y), jnp.asarray(lambdas), jnp.asarray(theta),
        jnp.asarray(n_vec), jnp.asarray(cn_s), safety=1e-6)
    fk_t, r_t = tdpc.dpc_screen_grid_feat(
        tops, Xt, t(y), t(lambdas), t(theta), t(n_vec), t(cn_s),
        safety=1e-6)
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)
    assert 0 < int(fk_t.sum()) < fk_t.numel()
    radii = np.linspace(0.05, 0.3, len(lambdas))
    c_s = ft.shard_features(X.T @ theta)
    np.testing.assert_array_equal(
        tdpc.gap_safe_screen_grid_nn_feat(tops, t(c_s), t(radii),
                                          t(cn_s)).numpy(),
        np.asarray(jdpc.gap_safe_screen_grid_nn_feat(
            jops, jnp.asarray(c_s), jnp.asarray(radii), jnp.asarray(cn_s))))
    K = 3
    masks = fold_masks(N, K, seed=6)
    Y = masks * y[None, :]
    lams_f = np.stack([lambdas * (1.0 + 0.01 * k) for k in range(K)])
    cn_f = ft.shard_features(np.sqrt(masks @ (X * X)))
    args_np = (Y, lams_f, masks * theta[None, :], masks * n_vec[None, :],
               cn_f)
    fk_j, r_j = jdpc.dpc_screen_grid_folds_feat(
        jops, Xj, *map(jnp.asarray, args_np), safety=1e-6)
    fk_t, r_t = tdpc.dpc_screen_grid_folds_feat(
        tops, Xt, *map(t, args_np), safety=1e-6)
    np.testing.assert_array_equal(fk_t.numpy(), np.asarray(fk_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)


def test_group_sum_on_a_padded_block():
    """A (2, 6) block with groups of 2 and 3 and one zero pad column: the
    pad joins the last group, and the second row's sums do not shift."""
    spec = T.GroupSpec.from_arrays(
        [2, 3], [0, 2], [0, 0, 1, 1, 1, 1], [1.0, 1.0],
        [[0, 1, 0], [2, 3, 4]], [[1, 1, 0], [1, 1, 1]], device="cpu")
    x = torch.tensor([[0.0, 1, 2, 3, 4, 0], [6, 7, 8, 9, 10, 0]])
    np.testing.assert_array_equal(group_sum(spec, x).numpy(),
                                  [[1, 9], [13, 27]])
    np.testing.assert_array_equal(group_sum(spec, x[1]).numpy(), [13, 27])
    with pytest.raises(ValueError, match="more than p"):
        T.GroupSpec.from_arrays([4, 3], [0, 4], [0] * 6, [1.0, 1.0],
                                [[0, 1, 2, 3], [4, 5, 0, 0]],
                                [[1, 1, 1, 1], [1, 1, 0, 0]], device="cpu")


@pytest.mark.parametrize("sizes", [(6,) * 16, RAGGED, (1, 4, 2, 9)])
def test_group_sum_unchanged_on_unpadded_specs(sizes):
    """Where the sizes sum to p (every spec but a block's), the segment
    sums are the segment reduction over ``sizes``, bit for bit: of a full
    spec and of a bucketed subset with empty groups and a garbage bin."""
    _, spec = _specs(sizes)
    p = spec.num_features
    keep = np.zeros(p, dtype=bool)
    keep[::3] = True
    sub, _ = spec.bucketed_subset(keep, int(keep.sum()) + 5,
                                  spec.num_groups + 1)
    gen = torch.Generator().manual_seed(p)
    for s in (spec, sub):
        for shape in ((s.num_features,), (3, s.num_features),
                      (2, 4, s.num_features)):
            x = torch.randn(shape, generator=gen, dtype=torch.float64)
            rows = x.numel() // s.num_features
            want = torch.segment_reduce(x.reshape(-1), "sum",
                                        lengths=s.sizes.repeat(rows))
            assert torch.equal(group_sum(s, x).reshape(-1), want)


# ---------------------------------------------------------------------------
# 3. Paths in float64
# ---------------------------------------------------------------------------

def _sgl_pair(sizes, screen, shards=8, seed=3):
    X, y, sizes = sgl_problem(seed=seed, sizes=sizes)
    jspec, _ = _specs(sizes)
    plan = dict(alpha=0.5, screen=screen, **PATH_KW)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).path(
        J.Plan(feature_shards=shards, **plan))
    st = T.SGLSession(convert.problem(X, y, _children(jspec), device="cpu"))
    rt = st.path(T.Plan(feature_shards=shards, **plan))
    ru = T.SGLSession(convert.problem(X, y, _children(jspec),
                                      device="cpu")).path(T.Plan(**plan))
    return rj, rt, ru


def _assert_path_parity(rj, rt, ru, groups=True):
    np.testing.assert_allclose(rt.lambdas, rj.lambdas, rtol=1e-12)
    assert np.abs(rt.betas - rj.betas).max() <= 1e-8
    assert np.abs(rt.betas).max() > 0.1
    np.testing.assert_array_equal(rt.kept_features, rj.kept_features)
    if groups:
        np.testing.assert_array_equal(rt.kept_groups, rj.kept_groups)
    assert _stats(rt.stats) == _stats(rj.stats)
    assert abs(int(rt.iters.sum()) - int(rj.iters.sum())) <= \
        0.1 * int(rj.iters.sum())
    # the port's sharded route against its unsharded route
    assert np.abs(rt.betas - ru.betas).max() <= 1e-12
    np.testing.assert_array_equal(rt.kept_features, ru.kept_features)


@pytest.mark.parametrize("screen", ["tlfre", "gapsafe", "none"])
def test_sgl_path_parity_f64(screen):
    _assert_path_parity(*_sgl_pair((6,) * 16, screen))


def test_sgl_path_parity_ragged_f64():
    """10 ragged groups over 8 requested shards: 5 blocks of unequal
    width, every one but the widest with pad columns."""
    rj, rt, ru = _sgl_pair(RAGGED, "tlfre")
    _assert_path_parity(rj, rt, ru)
    assert rt.stats.n_screens > 0


@pytest.mark.parametrize("screen", ["dpc", "gapsafe", "none"])
def test_nn_path_parity_f64(screen):
    X, y = nn_problem()
    plan = dict(screen=screen, **PATH_KW)
    rj = J.SGLSession(J.Problem.nn_lasso(X, y)).path(
        J.Plan(feature_shards=8, **plan))
    rt = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")).path(
        T.Plan(feature_shards=8, **plan))
    ru = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")).path(
        T.Plan(**plan))
    _assert_path_parity(rj, rt, ru, groups=False)


def test_feature_shards_zero_and_one_are_unsharded():
    X, y, sizes = sgl_problem(seed=6)
    _, tspec = _specs(sizes)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    kw = dict(n_lambdas=10, min_ratio=0.05, screen="tlfre", tol=1e-9)
    r0 = tpe.sgl_path_batched(Xt, yt, tspec, 0.5, feature_shards=0, **kw)
    r1 = tpe.sgl_path_batched(Xt, yt, tspec, 0.5, feature_shards=1, **kw)
    np.testing.assert_array_equal(r0.betas, r1.betas)
    np.testing.assert_array_equal(r0.kept_features, r1.kept_features)
    assert _stats(r0.stats) == _stats(r1.stats)


def test_sharded_compile_keys_and_warm_call():
    """A warm second sharded call pays no compilation, and the sharded
    keys do not collide with the unsharded ones."""
    X, y, sizes = sgl_problem()
    _, tspec = _specs(sizes)
    sess = T.SGLSession(T.Problem.sgl(X, y, tspec, device="cpu"))
    plan = T.Plan(alpha=0.5, n_lambdas=10, min_ratio=0.05, tol=1e-9)
    r1 = sess.path(plan.with_(feature_shards=4))
    r2 = sess.path(plan.with_(feature_shards=4))
    r3 = sess.path(plan)
    assert r1.stats.n_compilations > 0 and r2.stats.n_compilations == 0
    assert r3.stats.n_compilations == r1.stats.n_compilations
    assert all(k[0] in ("sgl", "sgl-feat") for k in sess.compile_keys)
    feat = [k for k in sess.compile_keys if k[0] == "sgl-feat"]
    assert feat and all(k[1] == 4 and k[8] is False for k in feat)


# ---------------------------------------------------------------------------
# 4. Fold paths, refine, stability
# ---------------------------------------------------------------------------

FOLD_KW = dict(tol=1e-13, max_iter=200_000, schedule="lockstep")


def _fold_grid(X, y, spec_j=None, alpha=0.5):
    if spec_j is None:
        lam_max = float(np.max(X.T @ y))
    else:
        lam_max = float(J.lambda_max_sgl(spec_j, jnp.asarray(X.T @ y),
                                         alpha)[0])
    return J.default_lambda_grid(lam_max, 10, 0.05)


def _assert_fold_parity(rj, rt, ru):
    bj, kj, ij, sj, _ = rj
    bt, kt, it, stt, _ = rt
    assert np.abs(bt - np.asarray(bj)).max() <= 1e-8
    assert np.abs(bt).max() > 0.05
    np.testing.assert_array_equal(kt, np.asarray(kj))
    assert _stats(stt) == _stats(sj)
    np.testing.assert_array_equal(stt.fold_sweeps, sj.fold_sweeps)
    assert abs(int(it.sum()) - int(np.sum(ij))) <= 0.1 * int(np.sum(ij))
    assert np.abs(bt - ru[0]).max() <= 1e-12
    np.testing.assert_array_equal(kt, ru[1])


def fold_problem(seed=7, N=60, G=30, n=5):
    """``tests/test_cv.py:_sgl_problem``."""
    rng = np.random.default_rng(seed)
    p = G * n
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    for g in rng.choice(G, 4, replace=False):
        beta[g * n + rng.choice(n, 2, replace=False)] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y, [n] * G


@pytest.mark.parametrize("screen,centered", [
    ("tlfre", False), ("gapsafe", False), ("none", False),
    ("tlfre", True), ("gapsafe", True), ("none", True)])
def test_sgl_fold_paths_parity_f64(screen, centered):
    """Screened cases on ``tests/test_cv.py``'s problem (30 groups: 8
    shards degrade to 6); unscreened ones on 240 rows for 40 features
    (160 training rows)."""
    X, y, sizes = (fold_problem(N=240, G=8) if screen == "none"
                   else fold_problem())
    jspec, tspec = _specs(sizes)
    N = X.shape[0]
    masks = fold_masks(N, 3, seed=7)
    grid = _fold_grid(X, y, jspec)
    mus, yy = None, y
    if centered:
        mus = (masks @ X) / masks.sum(axis=1)[:, None]
        yy = y[None, :] - ((masks @ y) / masks.sum(axis=1))[:, None]
    kw = dict(screen=screen, mus=mus, **FOLD_KW)
    rj = jcv.sgl_fold_paths(X, yy, jspec, 0.5, masks, grid,
                            feature_shards=8, **kw)
    Xt = torch.as_tensor(X)
    rt = tcv.sgl_fold_paths(Xt, yy, tspec, 0.5, masks, grid,
                            feature_shards=8, **kw)
    ru = tcv.sgl_fold_paths(Xt, yy, tspec, 0.5, masks, grid, **kw)
    _assert_fold_parity(rj, rt, ru)


@pytest.mark.parametrize("screen", ["dpc", "gapsafe", "none"])
def test_nn_fold_paths_parity_f64(screen):
    """The unscreened case takes 160 rows for 96 features."""
    X, y = nn_problem(seed=8, N=160 if screen == "none" else 40)
    masks = fold_masks(X.shape[0], 3, seed=8)
    grid = _fold_grid(X, y)
    kw = dict(screen=screen, **FOLD_KW)
    rj = jcv.nn_fold_paths(X, y, masks, grid, feature_shards=8, **kw)
    Xt = torch.as_tensor(X)
    rt = tcv.nn_fold_paths(Xt, y, masks, grid, feature_shards=8, **kw)
    ru = tcv.nn_fold_paths(Xt, y, masks, grid, **kw)
    _assert_fold_parity(rj, rt, ru)


def test_session_cv_parity_ragged():
    """``Plan(feature_shards=8)`` through ``SGLSession.cv`` on ragged
    groups (5 blocks), the default elastic schedule: the MSE path and the
    selection of the reference's sharded CV."""
    X, y, sizes = sgl_problem(seed=9, sizes=RAGGED)
    jspec, _ = _specs(sizes)
    plan = dict(n_lambdas=10, min_ratio=0.05, n_folds=3, tol=1e-13,
                max_iter=200_000, feature_shards=8)
    rj = J.SGLSession(J.Problem.sgl(X, y, jspec)).cv(J.Plan(**plan))
    rt = T.SGLSession(convert.problem(X, y, _children(jspec),
                                      device="cpu")).cv(T.Plan(**plan))
    assert np.abs(rt.fold_betas - rj.fold_betas).max() <= 1e-8
    assert np.abs(rt.mse_path - rj.mse_path).max() <= 1e-8
    assert rt.best_index == rj.best_index
    assert rt.index_1se == rj.index_1se


def test_refine_and_stability_with_two_shards():
    """``refine`` after a sharded CV, and ``stability``, with
    ``feature_shards=2``, against the reference's."""
    X, y, sizes = sgl_problem(seed=10, N=48, sizes=(6,) * 12)
    jspec, _ = _specs(sizes)
    plan = dict(n_lambdas=8, min_ratio=0.05, n_folds=3, tol=1e-13,
                max_iter=200_000, feature_shards=2, schedule="lockstep")
    sj = J.SGLSession(J.Problem.sgl(X, y, jspec))
    st = T.SGLSession(convert.problem(X, y, _children(jspec), device="cpu"))
    sj.cv(J.Plan(**plan))
    st.cv(T.Plan(**plan))
    fj = sj.refine(factor=4.0, n_lambdas=6)
    ft = st.refine(factor=4.0, n_lambdas=6)
    assert ft.warm_start_lambda == fj.warm_start_lambda
    assert np.abs(ft.fine.fold_betas - fj.fine.fold_betas).max() <= 1e-8
    assert ft.index == fj.index
    np.testing.assert_array_equal(ft.fine.kept_features,
                                  fj.fine.kept_features)
    splan = dict(n_lambdas=6, min_ratio=0.1, n_subsamples=4, batch_size=2,
                 tol=1e-10, feature_shards=2, screen="tlfre")
    pj = sj.stability(J.Plan(**splan))
    pt = st.stability(T.Plan(**splan))
    np.testing.assert_array_equal(pt.selection_probs, pj.selection_probs)
    assert pt.stats.n_screens == pj.stats.n_screens > 0


# ---------------------------------------------------------------------------
# 5. Refusals
# ---------------------------------------------------------------------------

def test_refusals_match_reference():
    X, y, sizes = sgl_problem()
    jspec, tspec = _specs(sizes)
    yb = (y > 0).astype(float)
    fw = np.linspace(0.5, 2.0, X.shape[1])
    cases = [
        (dict(loss="logistic", screen="gapsafe"), yb),
        (dict(feature_weights=fw), y),
        (dict(engine="legacy"), y),
    ]
    for extra, yy in cases:
        with pytest.raises(ValueError):
            J.SGLSession(J.Problem.sgl(X, yy, jspec)).path(
                J.Plan(feature_shards=4, **extra))
        with pytest.raises(ValueError):
            T.SGLSession(T.Problem.sgl(X, yy, tspec, device="cpu")).path(
                T.Plan(feature_shards=4, **extra))
    # the engines refuse what the plan would have refused
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    with pytest.raises(ValueError, match="squared loss"):
        tpe.sgl_path_batched(Xt, torch.as_tensor(yb), tspec, 0.5,
                             screen="gapsafe", loss="logistic",
                             feature_shards=4)
    with pytest.raises(ValueError, match="feature weights"):
        tcv.sgl_fold_paths(Xt, yt, tspec.reweighted(feature_weights=fw),
                           0.5, fold_masks(X.shape[0], 3), [1.0],
                           feature_shards=4)
