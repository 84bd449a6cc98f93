"""The port's core modules against the JAX package's, module by module, on
the same numpy inputs (float64 unless stated), plus the port's import
hygiene.

Tolerances: exact integer/bool equality for group bookkeeping and kept
sets; 1e-12 relative for closed-form float64 quantities (only summation
order differs); 1e-10 for FISTA betas at equal iteration counts.
"""
import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro.core import screening as jscreen
from repro.core.solver import fista_sgl as j_fista
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import screening as tscreen
from repro_torch.core.solver import fista_sgl as t_fista

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"

# the reference's functions under jit: one compilation per shape instead of
# one per operation keeps the file fast
j_lambda_max = jax.jit(J.lambda_max_sgl)
j_dual_scaling = jax.jit(J.dual_scaling_sgl)
j_roots = jax.jit(J.group_shrink_roots)
j_screen_grid = jax.jit(jscreen.tlfre_screen_grid)
j_normal = jax.jit(J.normal_vector_sgl)


def _children(jspec):
    return {f: (None if getattr(jspec, f) is None
                else np.asarray(getattr(jspec, f)))
            for f in convert.SPEC_FIELDS}


def _tspec(jspec):
    return convert.group_spec(_children(jspec), device=CPU)


def _ragged(seed=0, G=12, n_hi=6):
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.integers(1, n_hi + 1, size=G)]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _problem(seed=3, N=30, sizes=(4,) * 10):
    rng = np.random.default_rng(seed)
    p = int(sum(sizes))
    X = rng.standard_normal((N, p))
    beta = np.zeros(p)
    beta[:3] = rng.standard_normal(3)
    beta[p // 2:p // 2 + 2] = rng.standard_normal(2)
    y = X @ beta + 0.01 * rng.standard_normal(N)
    return X, y


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[3] * 5, _ragged(0), _ragged(1, 30, 9)])
def test_from_sizes_matches_reference(sizes):
    jspec = J.GroupSpec.from_sizes(sizes)
    tspec = T.GroupSpec.from_sizes(sizes, device=CPU)
    for f in convert.SPEC_FIELDS[:6]:
        np.testing.assert_array_equal(getattr(tspec, f).numpy(),
                                      np.asarray(getattr(jspec, f)))
    assert (tspec.num_groups, tspec.num_features, tspec.max_size,
            tspec.uniform) == (jspec.num_groups, jspec.num_features,
                               jspec.max_size, jspec.uniform)
    assert tspec.group_ids.dtype == torch.int64
    assert tspec.pad_index.dtype == torch.int64


@pytest.mark.parametrize("seed,p_b,g_b", [(0, 32, 16), (1, 64, 32),
                                          (2, 32, 24)])
def test_bucketed_subset_matches_reference_with_garbage_bin(seed, p_b, g_b):
    sizes = _ragged(seed, 20, 5)
    jspec = J.GroupSpec.from_sizes(sizes)
    rng = np.random.default_rng(seed)
    keep = rng.random(sum(sizes)) < 0.2
    keep[:2] = True
    jsub, jcols = jspec.bucketed_subset(keep, p_b, g_b)
    tsub, tcols = T.GroupSpec.from_sizes(sizes, device=CPU).bucketed_subset(
        keep, p_b, g_b)
    np.testing.assert_array_equal(tcols, jcols)
    for f in convert.SPEC_FIELDS[:6]:
        np.testing.assert_array_equal(getattr(tsub, f).numpy(),
                                      np.asarray(getattr(jsub, f)))
    sizes_b = tsub.sizes.numpy()
    assert (sizes_b[:-1] == 0).any()              # empty segments exist
    assert sizes_b[-1] > tsub.max_size            # the bin exceeds n_max
    # segment reductions over empty segments: 0 for sums, -inf for maxima
    x = rng.standard_normal(p_b)
    for fn in ("group_sum", "group_norms", "group_max_abs"):
        got = getattr(T, fn)(tsub, _t(x)).numpy()
        want = np.asarray(getattr(J, fn)(jsub, jnp.asarray(x)))
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # rows of a (R, p) batch reduce as each row alone
    rows = T.group_sum(tsub, _t(np.stack([x, -2.0 * x, x * x])))
    for r, v in zip(rows, (x, -2.0 * x, x * x)):
        assert torch.equal(r, T.group_sum(tsub, _t(v)))
    np.testing.assert_allclose(T.pad_groups(tsub, _t(x)).numpy(),
                               np.asarray(J.pad_groups(jsub, jnp.asarray(x))))


# ---------------------------------------------------------------------------
# lambda_max, dual scaling, norms, normals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,alpha", [([5] * 8, 1.0), (_ragged(4), 0.4),
                                         (_ragged(5, 25, 8), 2.5)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lambda_max_and_dual_scaling_match_reference(sizes, alpha, dtype):
    X, y = _problem(sizes=sizes)
    c = (X.T @ y).astype(dtype)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    tdt = getattr(torch, dtype)
    rtol = 1e-12 if dtype == "float64" else 2e-6
    lj, gj = j_lambda_max(jspec, jnp.asarray(c), alpha)
    lt, gt = T.lambda_max_sgl(tspec, _t(c, tdt), alpha)
    np.testing.assert_allclose(float(lt), float(lj), rtol=rtol)
    assert int(gt) == int(gj)
    rho = (y - X[:, :3] @ np.ones(3)) / (0.3 * float(lj))
    c2 = (X.T @ rho).astype(dtype)
    np.testing.assert_allclose(
        float(T.dual_scaling_sgl(tspec, _t(c2, tdt), alpha)),
        float(j_dual_scaling(jspec, jnp.asarray(c2), alpha)), rtol=rtol)
    np.testing.assert_allclose(
        T.group_shrink_roots(tspec, _t(c2, tdt), alpha).numpy(),
        np.asarray(j_roots(jspec, jnp.asarray(c2), alpha)),
        rtol=rtol, atol=1e-300)


@pytest.mark.parametrize("sizes", [[5] * 8, _ragged(6)])
def test_norms_match_reference(sizes):
    X, _ = _problem(sizes=sizes)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    Xj, Xt = jnp.asarray(X), _t(X)
    np.testing.assert_allclose(T.column_norms(Xt).numpy(),
                               np.asarray(J.column_norms(Xj)), rtol=1e-12)
    np.testing.assert_allclose(
        T.group_frobenius_norms(Xt, tspec).numpy(),
        np.asarray(J.group_frobenius_norms(Xj, jspec)), rtol=1e-12)
    np.testing.assert_allclose(
        T.group_spectral_norms(Xt, tspec).numpy(),
        np.asarray(J.group_spectral_norms(Xj, jspec)), rtol=1e-10)
    # the start vectors differ (numpy vs jax.random); both converge
    np.testing.assert_allclose(float(T.spectral_norm(Xt, iters=200)),
                               float(J.spectral_norm(Xj, iters=200)),
                               rtol=1e-8)


def test_normal_vector_and_ball_geometry_match_reference():
    sizes = _ragged(7)
    X, y = _problem(sizes=sizes)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    lam_max, g_star = J.lambda_max_sgl(jspec, jnp.asarray(X.T @ y), 1.0)
    lam_max = float(lam_max)
    theta_max = y / lam_max
    theta_in = 0.9 * y / (0.7 * lam_max)
    lambdas = lam_max * np.array([0.95, 0.8, 0.6, 0.6])
    for lam_bar, theta in ((lam_max, theta_max), (0.7 * lam_max, theta_in)):
        nj = j_normal(jnp.asarray(X), jnp.asarray(y), jspec,
                                 lam_bar, lam_max, jnp.asarray(theta),
                                 g_star)
        nt = T.normal_vector_sgl(_t(X), _t(y), tspec, lam_bar, lam_max,
                                 _t(theta), int(g_star))
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-12,
                                   atol=1e-13)
        cj, rj = jscreen.grid_ball_geometry(jnp.asarray(y),
                                            jnp.asarray(lambdas),
                                            jnp.asarray(theta), nj)
        ct, rt = T.grid_ball_geometry(_t(y), _t(lambdas), _t(theta), nt)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12,
                                   atol=1e-13)


def test_project_out_normal_zero_normal_guard():
    v = torch.tensor([[1.0, -2.0, 3.0], [0.0, 0.0, 0.0]])
    out = T.project_out_normal(v, torch.zeros(3))
    assert torch.equal(out, v)
    assert torch.isfinite(T.project_out_normal(v[0], torch.zeros(3))).all()


# ---------------------------------------------------------------------------
# screening
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[4] * 12, _ragged(8, 16, 7)])
def test_tlfre_screen_grid_kept_sets_match_reference(sizes):
    X, y = _problem(seed=9, sizes=sizes)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    Xj, yj, Xt, yt = jnp.asarray(X), jnp.asarray(y), _t(X), _t(y)
    lam_max, g_star = J.lambda_max_sgl(jspec, Xj.T @ yj, 1.0)
    lam_max = float(lam_max)
    col_j, gs_j = J.column_norms(Xj), J.group_spectral_norms(Xj, jspec)
    col_t, gs_t = T.column_norms(Xt), T.group_spectral_norms(Xt, tspec)
    lambdas = lam_max * np.geomspace(0.98, 0.05, 8)
    theta = y / lam_max
    nj = j_normal(Xj, yj, jspec, lam_max, lam_max,
                             jnp.asarray(theta), g_star)
    nt = T.normal_vector_sgl(Xt, yt, tspec, lam_max, lam_max, _t(theta),
                             int(g_star))
    gkj, fkj, rj = j_screen_grid(
        Xj, yj, jspec, 1.0, jnp.asarray(lambdas), lam_max,
        jnp.asarray(theta), nj, col_j, gs_j)
    gkt, fkt, rt = T.tlfre_screen_grid(
        Xt, yt, tspec, 1.0, _t(lambdas), lam_max, _t(theta), nt, col_t,
        gs_t)
    np.testing.assert_array_equal(gkt.numpy(), np.asarray(gkj))
    np.testing.assert_array_equal(fkt.numpy(), np.asarray(fkj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12)
    assert not fkt.numpy()[0].all()       # the screen does discard


def test_grid_group_stats_kernel_route_refuses_float64():
    spec = T.GroupSpec.uniform_groups(3, 2, device=CPU)
    with pytest.raises(TypeError):
        tscreen._grid_group_stats(spec, torch.zeros(2, 6, dtype=torch.float64),
                                  True)
    c_norm, c_inf = tscreen._grid_group_stats(
        spec, torch.zeros(2, 6, dtype=torch.float32), True)
    assert c_norm.shape == (2, 3) and c_inf.dtype == torch.float32


def test_grid_group_stats_kernel_route_matches_plain_f32():
    sizes = _ragged(10, 20, 7)
    spec = T.GroupSpec.from_sizes(sizes, device=CPU)
    C = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, sum(sizes))).astype(np.float32) * 2)
    for a, b in zip(tscreen._grid_group_stats(spec, C, True),
                    tscreen._grid_group_stats(spec, C, False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _permuted_specs(sizes, seed):
    """The reference's and the port's spec for ``sizes`` with the features
    renumbered by a random permutation, so no group is contiguous."""
    jspec = J.GroupSpec.from_sizes(sizes)
    ch = _children(jspec)
    p = int(sum(sizes))
    perm = np.random.default_rng(seed).permutation(p)
    gid = np.empty(p, dtype=ch["group_ids"].dtype)
    gid[perm] = ch["group_ids"]
    ch["group_ids"] = gid
    ch["pad_index"] = np.where(ch["pad_mask"], perm[ch["pad_index"]],
                               0).astype(ch["pad_index"].dtype)
    leaves, aux = jspec.tree_flatten()
    jperm = J.GroupSpec.tree_unflatten(
        aux, [ch[f] for f in convert.SPEC_FIELDS])
    return jperm, convert.group_spec(ch, device=CPU)


@pytest.mark.parametrize("sizes,permuted", [
    (_ragged(21, 30, 9), False), (_ragged(22, 30, 9), True),
    ([10] * 25, False), ([1] * 40, False), (_ragged(23, 8, 40), True)])
def test_grid_group_stats_kernel_route_matches_reference_pallas(sizes,
                                                                permuted):
    """The port's kernel route (the fused plain version on the CPU) against
    the reference's ``use_pallas=True`` route (gather, then the Pallas
    kernel in interpret mode), float32, on contiguous and permuted specs."""
    if permuted:
        jspec, tspec = _permuted_specs(sizes, seed=len(sizes))
    else:
        jspec = J.GroupSpec.from_sizes(sizes)
        tspec = T.GroupSpec.from_sizes(sizes, device=CPU)
    C = (np.random.default_rng(len(sizes)).standard_normal(
        (8, sum(sizes))) * 2).astype(np.float32)
    got = tscreen._grid_group_stats(tspec, torch.from_numpy(C), True)
    want = jscreen._grid_group_stats(jspec, jnp.asarray(C), True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (8, len(sizes))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_grid_group_stats_kernel_route_reads_C_through_the_spec(
        monkeypatch):
    """The kernel route hands the screen GEMM's output itself and the
    spec's padded view to ``ops.screen_norms_gather``: no padded copy of C
    is built in front of the kernel."""
    from repro_torch.kernels import ops
    spec = T.GroupSpec.from_sizes(_ragged(24, 10, 5), device=CPU)
    C = torch.randn(4, spec.num_features)
    seen = []
    real = ops.screen_norms_gather

    def recording(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(ops, "screen_norms_gather", recording)
    tscreen._grid_group_stats(spec, C, True)
    assert len(seen) == 1
    c_arg, idx_arg, mask_arg = seen[0]
    assert c_arg is C
    assert idx_arg is spec.pad_index and mask_arg is spec.pad_mask


# ---------------------------------------------------------------------------
# prox and solver
# ---------------------------------------------------------------------------

def test_sgl_prox_matches_reference():
    sizes = _ragged(11)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(sum(sizes)) * 2
    tg = rng.random(len(sizes)) * 2
    np.testing.assert_allclose(
        T.sgl_prox(tspec, _t(v), 0.4, _t(tg)).numpy(),
        np.asarray(J.sgl_prox(jspec, jnp.asarray(v), 0.4, jnp.asarray(tg))),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("sizes,alpha,frac", [([5] * 8, 1.0, 0.3),
                                              (_ragged(12), 0.5, 0.1)])
def test_fista_sgl_matches_reference_at_shared_lipschitz(sizes, alpha, frac):
    X, y = _problem(seed=13, sizes=sizes)
    jspec, tspec = J.GroupSpec.from_sizes(sizes), T.GroupSpec.from_sizes(
        sizes, device=CPU)
    lam_max = float(J.lambda_max_sgl(jspec, jnp.asarray(X.T @ y), alpha)[0])
    lam = frac * lam_max
    L = float(np.linalg.norm(X, 2) ** 2)          # shared step size
    beta0 = np.zeros(X.shape[1])
    kw = dict(max_iter=5000, check_every=10, tol=1e-12)
    rj = j_fista(jnp.asarray(X), jnp.asarray(y), jspec, lam, alpha, L,
                 jnp.asarray(beta0), **kw)
    rt = t_fista(_t(X), _t(y), tspec, lam, alpha, L, _t(beta0), **kw)
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-10)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta),
                               atol=1e-10)
    assert np.abs(rt.beta.numpy()).max() > 0


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
