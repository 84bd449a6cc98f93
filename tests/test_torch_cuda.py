"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch; there, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's ``conftest.py`` imports JAX).

Tolerances as in ``tests/test_torch_kernels.py``: rtol = atol = 1e-5 for
the per-row statistics and the prox (the screen's ``cinf``, a max, exactly), ``2 * N * eps * sum|x_ij v_i|`` per
column for the GEMV.  Masked slots hold 1e30 in the kernel's input and 0 in
the plain version's.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _poisoned(gen, rows, mask, dev):
    vals = torch.randn(rows, mask.shape[1], generator=gen) * 2
    m = mask.repeat(rows // mask.shape[0], 1)
    return (torch.where(m, vals, 0.0).to(dev),
            torch.where(m, vals, 1e30).to(dev))


def _mask(gen, G, n_max):
    m = torch.rand(G, n_max, generator=gen) < 0.7
    m[:, 0] = True
    return m


@pytest.mark.parametrize("N,p,offset", [
    (1, 1, 0), (250, 10_000, 0), (300, 1037, 0),    # ragged p, N split
    (1, 10_000, 0), (747, 4099, 0),                 # N = 1; p % 4 != 0
    (64, 5000, 1),                                  # unaligned base of X
])
def test_xtv_kernel_matches_plain(dev, N, p, offset):
    """Both paths of the kernel (128-bit loads and the scalar path), with
    and without N split across blocks, within ``2*N*eps*sum|x v|`` per
    column, and bit for bit the same on a second run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.xtv import xtv_cuda
    gen = torch.Generator().manual_seed(N + p)
    X = torch.randn(N * p + offset, generator=gen).to(dev)[offset:]
    X = X.view(N, p)
    v = torch.randn(N, generator=gen).to(dev)
    got = xtv_cuda(X, v)
    again = xtv_cuda(X, v)
    want = ref.xtv_ref(X, v)
    torch.cuda.synchronize()
    bound = N * EPS32 * (X.abs() * v.abs()[:, None]).sum(dim=0)
    assert bool(((got - want).abs() <= 2 * bound + 1e-30).all())
    assert torch.equal(got, again)


def _screen_inputs(gen, L, mask, idx, p, dev, offset=0):
    """C (L, p + 2) on the card, its column p holding 1e30 and p + 1 NaN,
    and the index with every masked slot pointing at one of the two
    (alternately).  ``offset`` shifts C's first element off a 16-byte
    boundary."""
    G, n_max = mask.shape
    flat = torch.randn(L * (p + 2) + offset, generator=gen) * 2
    C = flat.to(dev)[offset:].view(L, p + 2)
    C[:, p], C[:, p + 1] = 1e30, float("nan")
    alt = p + torch.arange(G * n_max).reshape(G, n_max) % 2
    idx = torch.where(mask, idx, alt)
    return C, idx.to(dev), mask.to(dev)


def _check_screen_norms(C, idx, mask):
    """The fused kernel against its plain version: every output finite,
    ``snorm2`` within rtol = atol = 1e-5, ``cinf`` (a max) exactly."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    s, i = screen_norms_cuda(C, idx, mask)
    s_ref, i_ref = ref.screen_norms_gather_ref(C, idx, mask)
    torch.cuda.synchronize()
    assert s.shape == i.shape == (C.shape[0], mask.shape[0])
    assert bool(torch.isfinite(s).all() and torch.isfinite(i).all())
    torch.testing.assert_close(s, s_ref, **TOL)
    assert torch.equal(i, i_ref)


@pytest.mark.parametrize("L,G,n_max", [(1, 1, 1), (4, 37, 9), (128, 1000, 10),
                                       (3, 50, 70)])
def test_screen_norms_kernel_matches_plain(dev, L, G, n_max):
    """Contiguous ragged groups (the small path's staged spans and the
    large path), every masked slot pointing at a 1e30 or a NaN column."""
    gen = torch.Generator().manual_seed(L * G * n_max)
    sizes = torch.randint(1, n_max + 1, (G,), generator=gen)
    mask = torch.arange(n_max)[None, :] < sizes[:, None]
    starts = torch.cumsum(sizes, 0) - sizes
    idx = starts[:, None] + torch.arange(n_max)[None, :]
    _check_screen_norms(*_screen_inputs(gen, L, mask, idx, int(sizes.sum()),
                                        dev))


@pytest.mark.parametrize("L,G,n_max,offset,keep", [
    (8, 300, 10, 0, 0.8), (5, 40, 32, 0, 0.8), (3, 20, 45, 0, 0.8),
    (8, 300, 10, 0, 1.0),                 # permuted uniform groups
    (16, 129, 7, 1, 0.8), (16, 129, 7, 1, 1.0)])         # unaligned C
def test_screen_norms_kernel_on_permuted_or_unaligned_spans(dev, L, G, n_max,
                                                            offset, keep):
    """A permuted ``pad_index`` (a tile's columns far apart: the gather
    branch; with uniform groups, after the kernel's guess of a contiguous
    window failed) and, with ``offset`` = 1, contiguous groups in a C whose
    rows start off every 16-byte boundary (scalar heads and tails)."""
    gen = torch.Generator().manual_seed(G * n_max + offset)
    mask = torch.rand(G, n_max, generator=gen) < keep
    mask[:, 0] = True
    p = int(mask.sum())
    cols = torch.arange(p) if offset else torch.randperm(p, generator=gen)
    idx = torch.zeros(G, n_max, dtype=torch.int64)
    idx[mask] = cols
    _check_screen_norms(*_screen_inputs(gen, L, mask, idx, p, dev, offset))


def test_screen_norms_kernel_on_table2_spec(dev):
    """Table 2's ragged spec (p = 100 000, n_max = 9) at 8 grid rows."""
    from repro_torch.core import GroupSpec
    from repro_torch.data_synth import ragged_sizes
    spec = GroupSpec.from_sizes(ragged_sizes(100_000, avg=4.5, seed=0),
                                device="cpu")
    assert spec.max_size == 9 and not bool(spec.pad_mask.all())
    gen = torch.Generator().manual_seed(7)
    _check_screen_norms(*_screen_inputs(gen, 8, spec.pad_mask,
                                        spec.pad_index, 100_000, dev))


def test_screen_norms_kernel_refuses_other_dtypes_and_layouts(dev):
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    C = torch.randn(4, 12, device=dev)
    idx = torch.arange(12, device=dev).reshape(3, 4)
    mask = torch.ones(3, 4, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        screen_norms_cuda(C.double(), idx, mask)
    with pytest.raises(TypeError):
        screen_norms_cuda(C, idx.int(), mask)
    with pytest.raises(TypeError):
        screen_norms_cuda(C, idx, mask.float())
    with pytest.raises(ValueError, match="contiguous"):
        screen_norms_cuda(torch.randn(12, 4, device=dev).T, idx, mask)
    with pytest.raises(ValueError, match="CUDA"):
        screen_norms_cuda(C, idx.cpu(), mask)
    with pytest.raises(ValueError, match="shape"):
        screen_norms_cuda(C, idx, mask[:2])


def _bucket_spec(sizes, keep, p_b, g_b, dev):
    """A bucketed spec whose garbage bin runs past n_max (columns that no
    valid slot covers), on the card."""
    from repro_torch.core import GroupSpec
    full = GroupSpec.from_sizes(sizes, device="cpu")
    gid = np.repeat(np.arange(len(sizes)), sizes)
    sub, _ = full.bucketed_subset(np.isin(gid, keep), p_b, g_b)
    return sub.to(dev)


@pytest.mark.parametrize("sizes,keep,p_b,g_b,t_l1", [
    ([1] * 40, [3, 7], 8, 4, 0.0),                      # n_max = 1
    ([3, 7, 1, 9, 5, 2, 8, 4] * 5, list(range(0, 40, 3)), 128, 16, 0.3),
    ([10] * 1000, list(range(0, 1000, 2)), 8192, 1024, 1.1),
    ([40, 35, 7, 50] * 5, [0, 3, 5, 9], 512, 16, 0.05),  # n_max > 32
])
def test_sgl_prox_kernel_matches_plain(dev, sizes, keep, p_b, g_b, t_l1):
    """The fused flat prox against its plain composition, with 1e30 in
    every column no valid slot covers: those come out exactly 0."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sgl_prox import sgl_prox_cuda
    spec = _bucket_spec(sizes, keep, p_b, g_b, dev)
    unc = spec.pad_uncovered
    assert bool(unc.any())
    gen = torch.Generator().manual_seed(p_b + g_b)
    v = (torch.randn(p_b, generator=gen) * 2).to(dev)
    v = torch.where(unc, 1e30, v)
    tl1 = torch.tensor([t_l1], device=dev)
    tg = (torch.rand(g_b, generator=gen) * 2).to(dev)
    got = sgl_prox_cuda(v, spec.pad_index, spec.pad_mask, unc, tl1, tg)
    want = ref.sgl_prox_flat_ref(v, spec.pad_index, spec.pad_mask, tl1, tg)
    torch.cuda.synchronize()
    assert bool((got[unc] == 0).all()) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("L,G,n_max", [(1, 1, 1), (5, 37, 9),
                                       (128, 1000, 10), (3, 50, 70)])
def test_padded_entry_points_launch_the_kernels(dev, L, G, n_max):
    """The reference's padded entry points (``ops.screen_norms``,
    ``screen_norms_batched``, ``sgl_prox_padded``) on the card, 1e30 and
    NaN in every masked slot, against their plain versions on clean data
    (``cinf`` and the masked prox slots exactly); each call is one launch
    of the existing kernel, counted under its name."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(L + G + n_max)
    mask = _mask(gen, G, n_max)
    vals = torch.randn(L, G, n_max, generator=gen) * 2
    nan_slot = torch.arange(G * n_max).reshape(G, n_max) % 2 == 1
    poison = torch.where(nan_slot, float("nan"), 1e30)
    dirty = torch.where(mask, vals, poison).to(dev)
    clean = torch.where(mask, vals, 0.0).to(dev)
    mask = mask.to(dev)
    t_group = (torch.rand(G, generator=gen) * 2).to(dev)

    def launched(fn):
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after if
                     after[k] != before[k]}

    (s, i), n = launched(lambda: ops.screen_norms(dirty[0], mask))
    ws, wi = ref.screen_norms_ref(clean[0], mask)
    assert n == {"screen_norms": 1} and s.shape == (G,)
    torch.testing.assert_close(s, ws, **TOL)
    assert torch.equal(i, wi)
    (s, i), n = launched(lambda: ops.screen_norms_batched(dirty, mask))
    ws, wi = ref.screen_norms_folds_ref(clean, mask)
    assert n == {"screen_norms": 1} and s.shape == (L, G)
    torch.testing.assert_close(s, ws, **TOL)
    assert torch.equal(i, wi)
    out, n = launched(lambda: ops.sgl_prox_padded(dirty[0], mask, 0.3,
                                                  t_group))
    want = ref.sgl_prox_ref(clean[0], mask, 0.3, t_group)
    assert n == {"sgl_prox": 1} and out.shape == (G, n_max)
    assert bool((out[~mask] == 0).all()) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, want, **TOL)


@pytest.mark.parametrize("shape", [(37, 10), (36, 9), (38, 9)])
def test_padded_entry_points_refuse_a_mask_of_another_shape(dev, shape):
    """On the card too, a padded input whose (G, n_max) is not the mask's
    raises before any launch: the kernels would read past it or cover only
    part of it."""
    from repro_torch.kernels import ops
    mask = torch.ones(37, 9, dtype=torch.bool, device=dev)
    c = torch.randn(*shape, device=dev)
    before = ops.launch_counts()
    for call in (lambda: ops.screen_norms(c, mask),
                 lambda: ops.screen_norms_batched(c[None], mask),
                 lambda: ops.sgl_prox_padded(c, mask, 0.1,
                                             torch.ones(37, device=dev))):
        with pytest.raises(ValueError, match="mask"):
            call()
    assert ops.launch_counts() == before


@pytest.mark.parametrize("KL,G,n_max", [(1, 1, 1), (24, 313, 9),
                                         (640, 1000, 10), (6, 37, 32),
                                         (70, 5, 33), (3, 20, 130)])
def test_screen_norms_folds_kernel_matches_plain(dev, KL, G, n_max):
    """Both paths of the kernel (n_max <= 32 and wider) on ragged masks,
    with 1e30 in every masked slot of the kernel's input."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.screen_norms_folds import screen_norms_folds_cuda
    gen = torch.Generator().manual_seed(KL * G * n_max)
    mask = _mask(gen, G, n_max)
    clean, poison = _poisoned(gen, KL * G, mask, dev)
    mask = mask.to(dev)
    got = screen_norms_folds_cuda(poison.reshape(KL, G, n_max), mask)
    want = ref.screen_norms_folds_ref(clean.reshape(KL, G, n_max), mask)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == (KL, G)
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("K,L,p", [(1, 1, 1), (5, 128, 10_000),
                                   (3, 9, 10_007), (2, 3, 300)])
def test_dpc_screen_folds_kernel_matches_plain_exactly(dev, K, L, p):
    from repro_torch.kernels import ref
    from repro_torch.kernels.dpc_screen_folds import dpc_screen_folds_cuda
    gen = torch.Generator().manual_seed(K * L * p)
    C = (torch.randn(K, L, p, generator=gen) * 0.5 + 0.6).to(dev)
    radii = torch.rand(K, L, generator=gen).to(dev)
    cn = (torch.rand(K, p, generator=gen) + 0.5).to(dev)
    got = dpc_screen_folds_cuda(C, radii, cn)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == (K, L, p)
    assert bool((got == ref.dpc_screen_folds_ref(C, radii, cn)).all())


def test_dpc_screen_folds_kernel_rounds_like_the_plain_form(dev):
    """On inputs where ``C + r*cn`` lands on 1.0 within one ulp, a fused
    multiply-add would flip ``n_flips`` decisions; the kernel flips none."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dpc_screen_folds import (borderline_inputs,
                                                      dpc_screen_folds_cuda)
    C, r, cn, n_flips = borderline_inputs(3, 16, 4099, seed=1)
    assert n_flips > 0
    C, r, cn = (torch.from_numpy(a).to(dev) for a in (C, r, cn))
    got = dpc_screen_folds_cuda(C, r, cn)
    torch.cuda.synchronize()
    assert bool((got == ref.dpc_screen_folds_ref(C, r, cn)).all())


def test_kernels_refuse_other_dtypes_and_layouts(dev):
    from repro_torch.kernels.dpc_screen_folds import dpc_screen_folds_cuda
    from repro_torch.kernels.screen_norms_folds import screen_norms_folds_cuda
    from repro_torch.kernels.xtv import xtv_cuda
    X = torch.randn(8, 16, device=dev)
    with pytest.raises(TypeError):
        xtv_cuda(X.double(), torch.randn(8, device=dev).double())
    with pytest.raises(ValueError, match="contiguous"):
        xtv_cuda(X.T, torch.randn(16, device=dev))
    c = torch.randn(4, 6, 5, device=dev)
    mask = torch.ones(6, 5, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        screen_norms_folds_cuda(c.double(), mask)
    with pytest.raises(TypeError):
        screen_norms_folds_cuda(c, mask.float())
    with pytest.raises(ValueError, match="contiguous"):
        screen_norms_folds_cuda(c.transpose(0, 1), mask[:4])
    with pytest.raises(ValueError, match="shape"):
        screen_norms_folds_cuda(c, mask[:5])
    C = torch.randn(2, 3, 7, device=dev)
    r, cn = torch.rand(2, 3, device=dev), torch.rand(2, 7, device=dev)
    with pytest.raises(TypeError):
        dpc_screen_folds_cuda(C.double(), r, cn)
    with pytest.raises(ValueError, match="contiguous"):
        dpc_screen_folds_cuda(C, r.T.contiguous().T, cn)
    with pytest.raises(ValueError, match="shape"):
        dpc_screen_folds_cuda(C, r, cn[:, :6])


def test_small_path_on_the_card_goes_through_the_kernels(dev):
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(0)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.sgl(X, y, [6] * 20)).path(
        T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16))
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("xtv", "screen_norms", "sgl_prox")), \
        counts
    assert counts["screen_norms_folds"] == counts["dpc_screen_folds"] == 0
    assert res.stats.n_pallas_screens == res.stats.n_screens > 0
    cpu = T.SGLSession(T.Problem.sgl(X, y, [6] * 20, device="cpu")).path(
        T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16,
               use_kernels=True))
    np.testing.assert_allclose(res.betas, cpu.betas, atol=1e-4)


def test_small_sgl_cv_on_the_card_goes_through_the_kernels(dev):
    """Fold-batched SGL CV on the card: every stacked screen through
    ``screen_norms_folds`` (one launch each), the sweeps through
    ``sgl_prox`` and ``xtv``; per-fold betas as the CPU kernel route's."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(1)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=3)
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.sgl(X, y, [6] * 20)).cv(plan)
    counts = ops.launch_counts()
    st = res.stats
    assert st.n_pallas_screens == st.n_screens == \
        counts["screen_norms_folds"] > 0
    assert counts["sgl_prox"] > 0 and counts["xtv"] > 0
    assert counts["screen_norms"] == counts["dpc_screen_folds"] == 0
    cpu = T.SGLSession(T.Problem.sgl(X, y, [6] * 20, device="cpu")).cv(
        plan.with_(use_kernels=True))
    np.testing.assert_allclose(res.fold_betas, cpu.fold_betas, atol=1e-4)


def test_small_nn_cv_on_the_card_goes_through_the_kernels(dev):
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(2)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=3)
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.nn_lasso(X, y)).cv(plan)
    counts = ops.launch_counts()
    st = res.stats
    assert st.n_pallas_screens == st.n_screens == \
        counts["dpc_screen_folds"] > 0
    assert counts["xtv"] > 0
    assert counts["screen_norms_folds"] == counts["sgl_prox"] == 0
    cpu = T.SGLSession(T.Problem.nn_lasso(X, y, device="cpu")).cv(
        plan.with_(use_kernels=True))
    np.testing.assert_allclose(res.fold_betas, cpu.fold_betas, atol=1e-4)


def _graph_problem():
    gen = np.random.default_rng(3)
    X = gen.standard_normal((80, 400)).astype(np.float32)
    beta = np.zeros(400, np.float32)
    beta[:12] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(80)).astype(np.float32)
    return X, y, [8] * 50


def test_graphed_fista_matches_eager_fista(dev):
    """The graphed block against the eager ``fista_sgl`` with the kernel
    prox, on a bucketed subproblem: equal iterations, betas within 1e-6
    relative; a second solve of the same shape replays, captures none."""
    from repro_torch.core import fista_sgl, fista_sgl_graphed
    from repro_torch.core.linalg import spectral_norm
    from repro_torch.core.path_engine import _padded_prox
    X, y, sizes = _graph_problem()
    spec = _bucket_spec(sizes, list(range(0, 50, 3)), 256, 32, dev)
    gid = np.repeat(np.arange(50), sizes)
    cols = np.nonzero(np.isin(gid, list(range(0, 50, 3))))[0]
    X_sub = torch.zeros((80, 256), device=dev)
    X_sub[:, :len(cols)] = torch.as_tensor(X[:, cols], device=dev)
    y_d = torch.as_tensor(y, device=dev)
    L = spectral_norm(X_sub, iters=25) ** 2
    lam = float(torch.max(torch.abs(X_sub.T @ y_d))) * 0.01
    kw = dict(max_iter=6000, check_every=10, tol=1e-6)   # about 9 blocks
    graphs = {}
    b0 = torch.zeros(256, device=dev)
    eager = fista_sgl(X_sub, y_d, spec, lam, 1.0, L, b0,
                      prox=_padded_prox(spec), **kw)
    for _ in range(2):                  # captures, then replays
        graphed = fista_sgl_graphed(X_sub, y_d, spec, lam, 1.0, L, b0,
                                    graphs=graphs, **kw)
        assert len(graphs) == 1
        assert graphed.iters == eager.iters > kw["check_every"]
        scale = float(eager.beta.abs().max())
        assert float((graphed.beta - eager.beta).abs().max()) <= 1e-6 * scale


def test_warm_path_captures_no_graph(dev):
    """The float32 path on the card replays captured blocks: every FISTA
    iteration is one ``sgl_prox`` launch, and a second warm ``.path``
    captures nothing and pays no compilation."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y, sizes = _graph_problem()
    sess = T.SGLSession(T.Problem.sgl(X, y, sizes))
    plan = T.Plan(n_lambdas=10, tol=1e-6, safety=1e-6, min_bucket=16,
                  check_every=20)
    ops.reset_launch_counts()
    cold = sess.path(plan)
    assert ops.launch_counts()["sgl_prox"] == cold.stats.fista_iters \
        >= cold.iters.sum() > 0
    n = len(sess.fista_graphs)
    assert 0 < n <= cold.stats.n_compilations
    assert all(g.recorded == {"sgl_prox": plan.check_every}
               for g in sess.fista_graphs.values())
    ops.reset_launch_counts()
    warm = sess.path(plan)
    assert len(sess.fista_graphs) == n
    assert warm.stats.n_compilations == 0
    assert ops.launch_counts()["sgl_prox"] == warm.stats.fista_iters
    np.testing.assert_array_equal(warm.iters, cold.iters)


def _small_sgl(seed=0, N=60, p=120):
    gen = np.random.default_rng(seed)
    X = gen.standard_normal((N, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(N)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("weighted", [False, True])
def test_gap_safe_rules_on_the_card_match_plain(dev, weighted):
    """The Gap-Safe grid rules on the card (the center row's statistics
    through one ``screen_norms`` launch, unweighted; no kernel, weighted)
    against the same rules on the CPU (the plain version): equal masks."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(4)
    sizes = [int(s) for s in gen.integers(1, 10, size=300)]
    p = sum(sizes)
    kw = {}
    if weighted:
        kw = dict(weights=gen.uniform(0.5, 2.0, len(sizes)),
                  feature_weights=gen.uniform(0.5, 2.0, p))
    args = [torch.as_tensor(a.astype(np.float32)) for a in (
        gen.standard_normal(p) * 1.5, gen.uniform(0.0, 0.3, 64),
        gen.uniform(0.5, 2.0, p), gen.uniform(0.5, 3.0, len(sizes)))]
    cpu = T.gap_safe_screen_grid(T.GroupSpec.from_sizes(sizes, device="cpu",
                                                        **kw), 0.8, *args,
                                 use_kernels=True)
    ops.reset_launch_counts()
    card = T.gap_safe_screen_grid(T.GroupSpec.from_sizes(sizes, device=dev,
                                                         **kw), 0.8,
                                  *(a.to(dev) for a in args),
                                  use_kernels=True)
    assert ops.launch_counts()["screen_norms"] == (0 if weighted else 1)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_small_gapsafe_path_on_the_card(dev):
    """Float32 Gap-Safe SGL path on the card: two ``screen_norms`` launches
    a screen (TLFre's grid and Gap-Safe's center row), one ``sgl_prox`` per
    FISTA iteration; betas as the CPU kernel route's."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y = _small_sgl()
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16,
                  screen="gapsafe")
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.sgl(X, y, [6] * 20)).path(plan)
    counts = ops.launch_counts()
    st = res.stats
    assert st.n_pallas_screens == st.n_screens > 0
    assert counts["screen_norms"] == 2 * st.n_pallas_screens
    assert counts["sgl_prox"] == st.fista_iters > 0 and counts["xtv"] > 0
    cpu = T.SGLSession(T.Problem.sgl(X, y, [6] * 20, device="cpu")).path(
        plan.with_(use_kernels=True))
    np.testing.assert_allclose(res.betas, cpu.betas, atol=1e-4)


def test_small_gapsafe_cv_on_the_card(dev):
    """Float32 Gap-Safe SGL CV: two ``screen_norms_folds`` launches a
    stacked screen (TLFre's K x L rows, Gap-Safe's K rows)."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y = _small_sgl(1)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=3, screen="gapsafe")
    ops.reset_launch_counts()
    res = T.SGLSession(T.Problem.sgl(X, y, [6] * 20)).cv(plan)
    counts = ops.launch_counts()
    st = res.stats
    assert st.n_pallas_screens == st.n_screens > 0
    assert counts["screen_norms_folds"] == 2 * st.n_screens
    assert counts["sgl_prox"] > 0 and counts["xtv"] > 0
    cpu = T.SGLSession(T.Problem.sgl(X, y, [6] * 20, device="cpu")).cv(
        plan.with_(use_kernels=True))
    np.testing.assert_allclose(res.fold_betas, cpu.fold_betas, atol=1e-4)


@pytest.mark.parametrize("case", ["feature_weights", "logistic"])
def test_weighted_and_logistic_paths_route_kernels_by_function(dev, case):
    """Each kernel runs where its function does.  Feature weights: ``xtv``
    certifies every row, the prox and the screen statistics run plainly
    (the fused ones take one l1 threshold) and the graphed block refuses
    the spec.  Logistic loss: one ``screen_norms`` launch a Gap-Safe
    screen, one ``sgl_prox`` a FISTA iteration on graphed blocks, ``xtv``
    every row; betas as the CPU kernel route's, within 1e-4 of the
    largest coefficient (both solves certified at tol 1e-6)."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y = _small_sgl(2)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16,
                  screen="gapsafe")
    if case == "logistic":
        prob = T.Problem.sgl_logistic(X, (y > 0).astype(np.float32),
                                      [6] * 20)
        cpu_prob = T.Problem.sgl_logistic(X, (y > 0).astype(np.float32),
                                          [6] * 20, device="cpu")
    else:
        prob = T.Problem.sgl(X, y, [6] * 20)
        cpu_prob = T.Problem.sgl(X, y, [6] * 20, device="cpu")
        plan = plan.with_(feature_weights=np.linspace(0.5, 2.0, 120))
    ops.reset_launch_counts()
    sess = T.SGLSession(prob)
    res = sess.path(plan)
    counts = ops.launch_counts()
    st = res.stats
    assert counts["xtv"] > 0 and st.n_screens > 0
    assert counts["screen_norms_folds"] == counts["dpc_screen_folds"] == 0
    if case == "logistic":
        assert counts["screen_norms"] == st.n_pallas_screens == st.n_screens
        assert counts["sgl_prox"] == st.fista_iters > 0
        assert sess.fista_graphs
    else:
        assert counts["screen_norms"] == counts["sgl_prox"] == 0
        assert st.n_pallas_screens == 0 and not sess.fista_graphs
        with pytest.raises(ValueError, match="feature weights"):
            T.fista_sgl_graphed(prob.X, prob.y, sess._effective(plan)[1],
                                0.1, 1.0, 100.0,
                                torch.zeros(120, device=dev), graphs={})
    cpu = T.SGLSession(cpu_prob).path(plan.with_(use_kernels=True))
    np.testing.assert_allclose(res.betas, cpu.betas,
                               atol=1e-4 * max(1.0, np.abs(cpu.betas).max()))


def test_plain_segment_sums_repeat_bitwise_on_the_card(dev):
    """The plain group sums (``group_sum``: the plain prox, the penalty,
    the weighted screen statistics) give the same bits on every call on
    the card, also inside a CUDA graph, and match the CPU's within 1e-5
    relative."""
    import repro_torch.core as T
    gen = np.random.default_rng(6)
    sizes = [int(s) for s in gen.integers(1, 12, size=2000)]
    spec = T.GroupSpec.from_sizes(sizes, device=dev)
    # the first 400 features, in a bucket whose garbage bin exceeds n_max
    sub, _ = spec.bucketed_subset(np.arange(sum(sizes)) < 400, 1024, 256)
    assert int(sub.sizes[-1]) > sub.max_size
    for sp in (spec, sub):
        x = torch.as_tensor(gen.standard_normal((3, sp.num_features)),
                            dtype=torch.float32, device=dev)
        first = T.group_sum(sp, x)
        assert all(torch.equal(T.group_sum(sp, x), first) for _ in range(20))
        assert torch.equal(T.group_sum(sp, x[1]), first[1])
        out = torch.empty_like(first[0])
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out.copy_(T.group_sum(sp, x[0]))
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            out.copy_(T.group_sum(sp, x[0]))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first[0])
        cpu = T.group_sum(sp.to("cpu"), x.cpu())
        np.testing.assert_allclose(first.cpu().numpy(), cpu.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_tlfre_screen_on_the_card_matches_plain(dev):
    """The one-ball TLFre screen of the per-lambda driver on the card:
    exactly one ``xtv`` launch (the GEMV ``X^T center``) and one
    ``screen_norms`` launch (the (1, p) row's statistics); keep masks equal
    to the plain versions' on the CPU, sups within rtol = atol = 1e-5."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(7)
    sizes = [int(s) for s in gen.integers(1, 10, size=300)]
    p = sum(sizes)
    X = gen.standard_normal((80, p)).astype(np.float32)
    center = (gen.standard_normal(80) * 0.15).astype(np.float32)
    args = [torch.as_tensor(a) for a in (
        X, center, np.linalg.norm(X, axis=0).astype(np.float32),
        gen.uniform(1.0, 3.0, len(sizes)).astype(np.float32))]
    radius = torch.tensor(0.02)

    def screen(device):
        Xd, c, cn, gs = (a.to(device) for a in args)
        return T.tlfre_screen(Xd, T.GroupSpec.from_sizes(sizes,
                                                         device=device),
                              0.8, T.DualBall(c, radius.to(device)), cn, gs,
                              safety=1e-6, use_kernels=True)
    cpu = screen("cpu")
    ops.reset_launch_counts()
    card = screen(dev)
    counts = ops.launch_counts()
    assert counts["xtv"] == counts["screen_norms"] == 1
    assert sum(counts.values()) == 2
    assert 0 < int(cpu.group_keep.sum()) < len(sizes)
    for f in ("group_keep", "feat_keep"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
    for f in ("s_sup", "t_sup"):
        np.testing.assert_allclose(getattr(card, f).cpu().numpy(),
                                   getattr(cpu, f).numpy(), **TOL)


def test_solve_sgl_graphed_matches_eager(dev):
    """``solve_sgl(..., use_kernels=True)`` on the card replays graphed
    blocks: the eager loop's iterations (``fista_sgl`` with the kernel
    prox), betas within 1e-6 * max|beta|, one ``sgl_prox`` launch a FISTA
    iteration; a second solve of the shape captures nothing."""
    from repro_torch.core import fista_sgl, solve_sgl
    from repro_torch.core.linalg import spectral_norm
    from repro_torch.core.path_engine import _padded_prox
    from repro_torch.kernels import ops
    import repro_torch.core as T
    X, y, sizes = _graph_problem()
    spec = T.GroupSpec.from_sizes(sizes, device=dev)
    Xd, yd = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
    L = spectral_norm(Xd) ** 2
    lam = float(torch.max(torch.abs(Xd.T @ yd))) * 0.05
    kw = dict(max_iter=6000, check_every=10, tol=1e-6)
    eager = fista_sgl(Xd, yd, spec, lam, 1.0, L, torch.zeros_like(Xd[0]),
                      prox=_padded_prox(spec), **kw)
    graphs = {}
    for _ in range(2):                  # captures, then replays
        ops.reset_launch_counts()
        graphed = solve_sgl(Xd, yd, spec, lam, 1.0, L, use_kernels=True,
                            graphs=graphs, **kw)
        assert len(graphs) == 1
        assert ops.launch_counts()["sgl_prox"] == graphed.iters
        assert graphed.iters == eager.iters > kw["check_every"]
        scale = float(eager.beta.abs().max())
        assert float((graphed.beta - eager.beta).abs().max()) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# Model selection on the card: refine, stability, the estimators, serving
# ---------------------------------------------------------------------------

def _f32_within(b32, b64, rel=1e-2):
    """Float32 against float64: within ``rel * max|beta_64|``."""
    scale = float(np.abs(b64).max())
    assert scale > 0.1
    assert float(np.abs(np.asarray(b32) - b64).max()) <= rel * scale


def _noisy_sgl(seed=4, N=80, p=120):
    """``_small_sgl`` with enough noise that the CV curve has an interior
    minimum to refine around."""
    gen = np.random.default_rng(seed)
    X = gen.standard_normal((N, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.5 * gen.standard_normal(N)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("penalty", ["sgl", "nn_lasso"])
def test_refine_on_the_card_goes_through_the_kernels(dev, penalty):
    """``cv`` then ``refine`` in float32: each stacked screen of the refine
    is one ``screen_norms_folds`` (SGL) or ``dpc_screen_folds`` (nonnegative
    Lasso) launch, ``xtv`` certifies, and SGL's FISTA iterations are
    graphed ``sgl_prox`` launches; a warm repeat of both calls adds no
    compilation and captures no graph; the refined betas within 1e-2 *
    max|beta| of float64's on the card."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y = _noisy_sgl()
    make = (lambda X, y, **kw: T.Problem.sgl(X, y, [6] * 20, **kw)) \
        if penalty == "sgl" else T.Problem.nn_lasso
    plan = T.Plan(n_lambdas=12, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=3)
    sess = T.SGLSession(make(X, y))
    sess.cv(plan)
    ops.reset_launch_counts()
    ref = sess.refine(factor=10.0)
    counts = ops.launch_counts()
    st = ref.fine.stats
    fold_kernel = ("screen_norms_folds" if penalty == "sgl"
                   else "dpc_screen_folds")
    assert counts[fold_kernel] == st.n_pallas_screens == st.n_screens > 0
    assert counts["xtv"] > 0 and counts["screen_norms"] == 0
    if penalty == "sgl":
        assert counts["sgl_prox"] == st.fista_iters > 0
    else:
        assert counts["sgl_prox"] == counts["screen_norms_folds"] == 0
    n_graphs = len(sess.fista_graphs)
    sess.cv(plan)
    warm = sess.refine(factor=10.0)
    assert warm.new_compilations == 0 and len(sess.fista_graphs) == n_graphs
    sess64 = T.SGLSession(make(X.astype(np.float64), y.astype(np.float64)))
    sess64.cv(plan)
    ref64 = sess64.refine(factor=10.0)
    _f32_within(ref.fine.fold_betas, ref64.fine.fold_betas)


def _recording_fold_paths(monkeypatch):
    """Wraps the session's ``sgl_fold_paths``; returns the list of the
    betas (B, J, p) of every call."""
    from repro_torch.core import session
    seen, orig = [], session.sgl_fold_paths

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out[0])
        return out
    monkeypatch.setattr(session, "sgl_fold_paths", recorded)
    return seen


def test_stability_on_the_card_goes_through_the_kernels(dev, monkeypatch):
    """``stability`` in float32 on float64's grid: every stacked screen one
    ``screen_norms_folds`` launch, ``sgl_prox`` graphed, ``xtv``; a warm
    repeat adds no compilation.  A (subsample, lambda, feature) is active
    in one dtype and not the other only where float64's |beta| lies within
    1e-2 * max|beta| of ``active_tol`` (the float32 bar on betas)."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    X, y = _small_sgl(5, N=80)
    plan = T.Plan(n_subsamples=6, batch_size=3, n_lambdas=6, min_ratio=0.05,
                  tol=1e-7, specnorm_method="fro", min_bucket=16)
    seen = _recording_fold_paths(monkeypatch)
    s64 = T.SGLSession(T.Problem.sgl(X.astype(np.float64),
                                     y.astype(np.float64), [6] * 20)
                       ).stability(plan)
    b64 = np.concatenate(seen)
    plan = plan.with_(lambdas=s64.lambdas)
    sess = T.SGLSession(T.Problem.sgl(X, y, [6] * 20))
    seen.clear()
    ops.reset_launch_counts()
    s32 = sess.stability(plan)
    counts = ops.launch_counts()
    b32 = np.concatenate(seen)
    st = s32.stats
    assert counts["screen_norms_folds"] == st.n_screens > 0
    assert counts["sgl_prox"] == st.fista_iters > 0 and counts["xtv"] > 0
    assert sess.stability(plan).stats.n_compilations == 0
    tol = plan.active_tol
    flips = (np.abs(b32) > tol) != (np.abs(b64) > tol)
    band = 1e-2 * np.abs(b64).max() + tol
    assert bool((np.abs(b64[flips]) <= band).all())
    np.testing.assert_array_equal(s32.max_probs[:6], s64.max_probs[:6])


def test_estimators_on_the_card_go_through_the_kernels(dev):
    """``SGLCV`` float32: the CV's kernels and a graphed refit from the
    session's cache (``sgl_prox`` beyond the CV's FISTA iterations);
    ``NNLassoCV``: ``dpc_screen_folds`` and ``xtv``; ``SGLClassifier``:
    ``screen_norms``, ``sgl_prox`` and ``xtv``.  Each float32 fit within
    1e-2 * max|coef| of float64's on the card."""
    from repro_torch import api
    from repro_torch.kernels import ops
    X, y = _noisy_sgl(6)
    y = y + 3.0
    kw = dict(groups=[6] * 20, n_folds=3, n_lambdas=10, tol=1e-6,
              safety=1e-5)
    ops.reset_launch_counts()
    cv32 = api.SGLCV(dtype=torch.float32, **kw).fit(X, y)
    counts = ops.launch_counts()
    st = cv32.cv_result_.stats
    assert counts["screen_norms_folds"] == st.n_screens > 0
    assert counts["sgl_prox"] == st.fista_iters + cv32.n_iter_
    assert counts["xtv"] > 0
    cv64 = api.SGLCV(dtype=torch.float64, **kw).fit(X, y)
    assert cv32.lambda_ == pytest.approx(cv64.lambda_, rel=1e-5)
    _f32_within(cv32.coef_, cv64.coef_)
    ops.reset_launch_counts()
    nn32 = api.NNLassoCV(n_folds=3, n_lambdas=10, tol=1e-6, safety=1e-5,
                         dtype=torch.float32).fit(X, y)
    counts = ops.launch_counts()
    assert counts["dpc_screen_folds"] > 0 and counts["xtv"] > 0
    assert counts["sgl_prox"] == counts["screen_norms_folds"] == 0
    assert nn32.coef_.min() >= 0.0
    labels = (y > 3.0).astype(np.float32)
    ops.reset_launch_counts()
    clf32 = api.SGLClassifier(lam=2.0, groups=[6] * 20, tol=1e-6,
                              dtype=torch.float32).fit(X, labels)
    counts = ops.launch_counts()
    assert counts["screen_norms"] > 0 and counts["xtv"] > 0
    assert counts["sgl_prox"] == clf32.n_iter_ > 0
    clf64 = api.SGLClassifier(lam=2.0, groups=[6] * 20, tol=1e-6,
                              dtype=torch.float64).fit(X, labels)
    _f32_within(clf32.coef_, clf64.coef_)


def test_server_on_the_card_stacks_folds_through_the_kernels(dev):
    """``SGLServer`` float32 on the card: every job returns without error,
    each design's jobs share one fold-stacked engine call whose stacked
    screens are ``screen_norms_folds`` launches, the refits replay graphed
    ``sgl_prox`` blocks; a warm drain adds no compilation; each job within
    1e-2 * max|coef| of the float64 server's."""
    from repro_torch.core import Plan
    from repro_torch.kernels import ops
    from repro_torch.launch import sgl_serve
    rng = np.random.default_rng(0)
    jobs = sgl_serve._synthetic_jobs(rng, 2, 2, 60, 20, 6)
    plan = Plan(n_folds=3, n_lambdas=8, tol=1e-6, safety=1e-5,
                min_bucket=16)
    out = {}
    for dtype in (torch.float32, torch.float64):
        server = sgl_serve.SGLServer(plan, dtype=dtype)
        for X, y in jobs:
            server.submit(X, y, groups=[6] * 20)
        ops.reset_launch_counts()
        out[dtype] = server.drain()
        counts = ops.launch_counts()
        assert all(r.error is None for r in out[dtype].values())
        assert out[dtype][0].batched_with == [0, 1]
        if dtype == torch.float32:
            assert counts["screen_norms_folds"] == \
                server.stats.n_screens > 0
            assert counts["sgl_prox"] == server.stats.fista_iters + sum(
                r.n_iter for r in out[dtype].values())
            for X, y in jobs:
                server.submit(X, y, groups=[6] * 20)
            assert all(r.new_compilations == 0
                       for r in server.drain().values())
        else:
            assert sum(counts.values()) == 0
    for jid, r in out[torch.float32].items():
        _f32_within(r.coef, out[torch.float64][jid].coef)


def _rows_certified(res):
    """Rows a path certified: each segment's accepted rows, and the
    failed row where it stopped early."""
    return sum(k + (k < m) for _, _, m, k in res.stats.buckets)


def test_sharded_path_on_the_card_launches_per_block(dev):
    """``Plan(feature_shards=4)`` on the card (the stacked executor):
    ``xtv`` once a block a certified row, ``screen_norms`` once a block a
    screen, graphed ``sgl_prox`` once a FISTA iteration; the betas within
    the float32 bar (1e-2 * max|beta|) of the same route with the kernels
    off."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(4)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16,
                  feature_shards=4)
    for screen in ("tlfre", "gapsafe"):
        sess = T.SGLSession(T.Problem.sgl(X, y, [6] * 20))
        ops.reset_launch_counts()
        res = sess.path(plan.with_(screen=screen))
        counts = ops.launch_counts()
        st = res.stats
        per_screen = 2 if screen == "gapsafe" else 1
        assert counts["xtv"] == 4 * _rows_certified(res) > 0, counts
        assert counts["screen_norms"] == 4 * per_screen * st.n_screens > 0
        assert counts["sgl_prox"] == st.fista_iters > 0
        assert counts["screen_norms_folds"] == counts["dpc_screen_folds"] == 0
        assert st.n_pallas_screens == st.n_screens
        plain = sess.path(plan.with_(screen=screen, use_kernels=False))
        assert np.abs(res.betas - plain.betas).max() <= \
            1e-2 * np.abs(plain.betas).max()


def test_sharded_cv_on_the_card_launches_per_block(dev):
    """Sharded fold screens on the card: each stacked screen one
    ``screen_norms_folds`` (SGL) or ``dpc_screen_folds`` (nonnegative
    Lasso) launch a block; the fold betas within the float32 bar of the
    same CV with the kernels off."""
    import repro_torch.core as T
    from repro_torch.kernels import ops
    gen = np.random.default_rng(5)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=3, feature_shards=4)
    for prob, kernel in ((T.Problem.sgl(X, y, [6] * 20),
                          "screen_norms_folds"),
                         (T.Problem.nn_lasso(X, y), "dpc_screen_folds")):
        sess = T.SGLSession(prob)
        ops.reset_launch_counts()
        res = sess.cv(plan)
        counts = ops.launch_counts()
        st = res.stats
        assert counts[kernel] == 4 * st.n_screens > 0, counts
        assert st.n_pallas_screens == st.n_screens
        assert counts["xtv"] > 0 and counts["screen_norms"] == 0
        plain = sess.cv(plan.with_(use_kernels=False))
        assert np.abs(res.fold_betas - plain.fold_betas).max() <= \
            1e-2 * np.abs(plain.fold_betas).max()


def test_fold_mesh_of_one_on_the_card_equals_no_mesh(dev):
    """``Plan(mesh=make_fold_mesh(4))`` in one process on the card: a mesh
    of one, so the sweep runs unsplit: fold betas, counters and launches
    equal to the run without a mesh, bit for bit, and the session's keys
    and graphs inside the audit's universes."""
    import repro_torch.core as T
    from repro_torch.analysis import compile_audit as ca
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (fold_counts, make_fold_mesh,
                                         reset_fold_counts)
    gen = np.random.default_rng(6)
    X = gen.standard_normal((60, 120)).astype(np.float32)
    beta = np.zeros(120, np.float32)
    beta[:6] = 1.0
    y = (X @ beta + 0.01 * gen.standard_normal(60)).astype(np.float32)
    plan = T.Plan(n_lambdas=8, tol=1e-6, safety=1e-5, min_bucket=16,
                  n_folds=4)
    out = []
    for mesh in (None, make_fold_mesh(4)):
        sess = T.SGLSession(T.Problem.sgl(X, y, [6] * 20))
        ops.reset_launch_counts()
        reset_fold_counts()
        res = sess.cv(plan.with_(mesh=mesh))
        out.append((res, ops.launch_counts()))
        shape = ca.ProblemShape.of(sess.problem)
        assert ca.verify_paid_keys(sess.compile_keys, ca.predict_keys(
            shape, plan.with_(mesh=mesh), kinds=("cv",))) == []
        assert ca.verify_paid_graphs(sess.fista_graphs, ca.predict_graph_keys(
            shape, plan, kinds=("cv",))) == []
        assert len(sess.fista_graphs) > 0
    assert fold_counts() == {"sharded": 0, "unsharded": 0, "all_gather": 0}
    (a, launches_a), (b, launches_b) = out
    np.testing.assert_array_equal(b.fold_betas, a.fold_betas)
    assert b.stats.buckets == a.stats.buckets
    assert launches_b == launches_a
    assert launches_b["sgl_prox"] == b.stats.fista_iters > 0


def test_mask_coverage_on_the_card_is_clean(dev):
    """The five kernels under 1e30 in every masked slot, against their
    plain versions (``repro_torch.analysis.kernel_check``)."""
    from repro_torch.analysis import kernel_check
    errors = {}
    assert kernel_check.mask_coverage("cuda", errors) == []
    assert len(errors) == 5
    assert kernel_check.f64_gate() == []


# ---------------------------------------------------------------------------
# the LM's dense decoders (the plain torch path; the curve's kernels)
# ---------------------------------------------------------------------------

def _lm_params(cfg, seed, dev):
    from repro_torch.models import model as M
    from repro_torch.pytree import ParamTree, tree_map
    cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
    return cpu, ParamTree(tree_map(lambda t: t.detach().to(dev, copy=True),
                                   cpu))


def test_lm_decode_matches_full_forward_on_the_card(dev):
    """Reduced gemma2 (window 32) decoded for 48 steps into a 64-slot cache
    (the local ring wraps): within the reference's 2e-2 of the full
    forward, and within 1e-4 of the CPU's decode."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("gemma2-2b").reduced()
    cpu, card = _lm_params(cfg, 0, dev)
    B, T_ = 2, 48
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T_)))
    with torch.no_grad():
        x = M.embed_tokens(card, cfg, toks.to(dev), torch.float32)
        x, _, _ = M.decoder_stack(card, x, torch.arange(T_, device=dev), cfg,
                                  remat="none")
        full = M.logits_fn(card, cfg, M.rms_norm(x, card["final_norm"],
                                                 cfg.norm_eps))
        out = {}
        for name, params, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            caches = M.init_cache(cfg, B, 64, torch.float32, device=d)
            steps = []
            for t in range(T_):
                logits, caches = M.forward_decode(
                    params, cfg, caches, toks[:, t:t + 1].to(d), t,
                    compute_dtype=torch.float32)
                steps.append(logits[:, 0].cpu())
            out[name] = torch.stack(steps, 1)
    assert float((out["card"] - full.cpu()).abs().max()) < 2e-2
    torch.testing.assert_close(out["card"], out["cpu"], rtol=0, atol=1e-4)


def test_lm_train_step_on_the_card_matches_the_cpu(dev):
    """Two float32 train steps with the SGL prox, from equal weights on equal
    batches: losses within 1e-5 relative, parameters within 1e-5."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import sgl_prox_step
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    cfg = get_config("gemma3-12b").reduced()
    step = make_train_step(cfg, remat="full", compute_dtype=torch.float32,
                           lr_kwargs=dict(base_lr=1e-2, warmup=1, total=10))
    states = [adamw.init_state(p) for p in _lm_params(cfg, 1, dev)]
    gen = np.random.default_rng(2)
    for i in range(2):
        toks = torch.as_tensor(gen.integers(0, cfg.vocab_size, (4, 33)))
        losses = []
        for j, d in enumerate(("cpu", dev)):
            batch = {"tokens": toks[:, :-1].to(d), "labels": toks[:, 1:].to(d)}
            states[j], metrics = step(states[j], batch)
            sgl_prox_step(states[j].params, cfg, 1e-3, 1e-4)
            losses.append(float(metrics["loss"]))
        assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip(leaves(states[0]), leaves(states[1])):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)


def test_lm_pruning_curve_launch_counts(dev):
    """The example's curve over 256 channels, float32 on the card: ``xtv``
    once a row certified, ``screen_norms`` once a screen, ``sgl_prox`` once
    a FISTA iteration (graphed); the float64 twin keeps the same channels
    on every row and launches nothing."""
    from repro_torch.examples.sgl_pruned_lm import pruning_threshold_curve
    from repro_torch.kernels import ops
    signal = np.random.default_rng(3).uniform(0.5, 2.0, 256)
    ops.reset_launch_counts()
    res, surv = pruning_threshold_curve(signal, device=dev)
    counts = ops.launch_counts()
    st = res.stats
    rows = sum(k + (k < m) for _, _, m, k in st.buckets)
    assert counts["xtv"] == rows > 0
    assert counts["screen_norms"] == st.n_pallas_screens == st.n_screens > 0
    assert counts["sgl_prox"] == st.fista_iters > 0
    ops.reset_launch_counts()
    _, surv64 = pruning_threshold_curve(signal, device=dev,
                                        dtype=torch.float64)
    assert sum(ops.launch_counts().values()) == 0
    np.testing.assert_array_equal(surv64, surv)
    assert surv[0] == 0 and surv[-1] == 256


# ---------------------------------------------------------------------------
# MLA attention and the MoE FFN (plain torch on the card)
# ---------------------------------------------------------------------------

def test_mla_absorbed_decode_matches_expanded_on_the_card(dev):
    """Reduced minicpm3's first MLA layer: 20 absorbed decode steps into a
    32-slot latent cache, each within 1e-5 of the expanded forward's row on
    the card and of the CPU's decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as A
    cfg = get_config("minicpm3-4b").reduced()
    cpu, card = _lm_params(cfg, 0, dev)
    layer = {d: {k: v[0] for k, v in p["blocks"]["l0"]["attn"].items()}
             for d, p in (("cpu", cpu), (dev, card))}
    B, T_, S = 2, 20, 32
    x = torch.randn((B, T_, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        full, _ = A.mla_forward(layer[dev], x.to(dev),
                                torch.arange(T_, device=dev), cfg)
        steps = {}
        for d in ("cpu", dev):
            ckv, kr = A.mla_cache_shape(cfg, B, S)
            cache = A.MLACache(torch.zeros(ckv, device=d),
                               torch.zeros(kr, device=d))
            out = []
            for t in range(T_):
                y, cache = A.mla_forward(
                    layer[d], x[:, t:t + 1].to(d),
                    torch.full((1,), t, device=d), cfg, cache=cache,
                    cache_pos=t)
                out.append(y[:, 0].cpu())
            steps[d] = torch.stack(out, 1)
    torch.testing.assert_close(steps[dev], full.cpu(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(steps[dev], steps["cpu"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cf", [1.25, None])
def test_moe_forward_on_the_card_matches_the_cpu_and_repeats(dev, cf):
    """Reduced deepseek-v2's MoE layer (routed and shared experts) on 256
    tokens: within 1e-4 of the CPU's output (the same tokens dropped at
    capacity 1.25), and two calls on the card bit for bit; the second
    call synchronizes with the host nowhere (the sync debug mode raises)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-236b").reduced()
    cpu, card = _lm_params(cfg, 3, dev)
    ffn = {d: {k: v[0] for k, v in p["blocks"]["l0"]["ffn"].items()}
           for d, p in (("cpu", cpu), (dev, card))}
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        want, aux_c = moe.moe_forward(ffn["cpu"], x, cfg, capacity_factor=cf)
        xd = x.to(dev)
        got, aux_g = moe.moe_forward(ffn[dev], xd, cfg, capacity_factor=cf)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again, aux_a = moe.moe_forward(ffn[dev], xd, cfg,
                                           capacity_factor=cf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    assert abs(float(aux_g) - float(aux_c)) <= 1e-5 * float(aux_c)
    assert torch.equal(got, again) and torch.equal(aux_g, aux_a)


def test_deepseek_v2_decode_matches_full_forward_on_the_card(dev):
    """Reduced deepseek-v2 (a dense prologue, MLA, MoE) decoded for 48
    steps into a 64-slot cache against the full forward at
    ``capacity_factor=None``: within 1e-4."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("deepseek-v2-236b").reduced()
    _, card = _lm_params(cfg, 0, dev)
    B, T_ = 2, 48
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T_)), device=dev)
    with torch.no_grad():
        x = M.embed_tokens(card, cfg, toks, torch.float32)
        x, _, _ = M.decoder_stack(card, x, torch.arange(T_, device=dev), cfg,
                                  remat="none", capacity_factor=None)
        full = M.logits_fn(card, cfg, M.rms_norm(x, card["final_norm"],
                                                 cfg.norm_eps))
        caches = M.init_cache(cfg, B, 64, torch.float32, device=dev)
        for t in range(T_):
            logits, caches = M.forward_decode(card, cfg, caches,
                                              toks[:, t:t + 1], t,
                                              compute_dtype=torch.float32)
            assert float((logits[:, 0] - full[:, t]).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# Mamba2 with shared attention, and xLSTM (plain torch on the card)
# ---------------------------------------------------------------------------

def _full_logits(M, params, cfg, toks):
    x = M.embed_tokens(params, cfg, toks, torch.float32)
    x, _, _ = M.decoder_stack(params, x, torch.arange(
        toks.shape[1], device=toks.device), cfg, remat="none")
    return M.logits_fn(params, cfg, M.rms_norm(x, params["final_norm"],
                                               cfg.norm_eps))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_recurrent_decode_matches_full_forward_on_the_card(dev, arch):
    """Reduced zamba2 (the conv ring, the SSM state, the shared block's KV
    cache) and xlstm (the mLSTM and sLSTM caches) decoded for 48 steps
    into a 64-slot cache: within 1e-4 * max|logits| of the full forward on
    the card, and of the CPU's decode."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    cpu, card = _lm_params(cfg, 0, dev)
    B, T_ = 2, 48
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, T_)))
    with torch.no_grad():
        full = _full_logits(M, card, cfg, toks.to(dev)).cpu()
        out = {}
        for name, params, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            caches = M.init_cache(cfg, B, 64, torch.float32, device=d)
            steps = []
            for t in range(T_):
                logits, caches = M.forward_decode(
                    params, cfg, caches, toks[:, t:t + 1].to(d), t,
                    compute_dtype=torch.float32)
                steps.append(logits[:, 0].cpu())
            out[name] = torch.stack(steps, 1)
    tol = 1e-4 * float(full.abs().max())
    torch.testing.assert_close(out["card"], full, rtol=0, atol=tol)
    torch.testing.assert_close(out["card"], out["cpu"], rtol=0, atol=tol)


@pytest.mark.parametrize("arch,seq", [("zamba2-2.7b", 64),
                                      ("xlstm-350m", 256)])
def test_recurrent_train_step_on_the_card_matches_the_cpu(dev, arch, seq):
    """Reduced zamba2 (two repeats: both shared blocks) and xlstm (S 256:
    the sLSTM's two checkpointed chunks): each gradient leaf within the
    CPU tests' bars of the CPU's (1e-4 relative L2; xlstm 1e-3), then two
    float32 train steps from equal weights on equal batches, losses
    within 1e-5 relative."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    cfg = get_config(arch).reduced()
    if arch == "zamba2-2.7b":
        cfg = dataclasses.replace(cfg, num_layers=12)
    pair = _lm_params(cfg, 1, dev)
    gen = np.random.default_rng(2)
    batches = [torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, seq + 1)))
               for _ in range(2)]
    batch = lambda toks, d: {"tokens": toks[:, :-1].to(d),
                             "labels": toks[:, 1:].to(d)}
    grads = []
    for params, d in zip(pair, ("cpu", dev)):
        loss, _ = M.forward_train(params, cfg, batch(batches[0], d),
                                  remat="full", compute_dtype=torch.float32)
        grads.append(torch.autograd.grad(loss, leaves(params)))
    bar = 1e-3 if arch == "xlstm-350m" else 1e-4
    for a, b in zip(*grads):
        err = torch.linalg.vector_norm(b.cpu() - a) / torch.clamp(
            torch.linalg.vector_norm(a), min=1e-30)
        assert float(err) < bar
    step = make_train_step(cfg, remat="full", compute_dtype=torch.float32,
                           lr_kwargs=dict(base_lr=1e-3, warmup=1, total=10))
    states = [adamw.init_state(p) for p in pair]
    for toks in batches:
        losses = []
        for j, d in enumerate(("cpu", dev)):
            states[j], metrics = step(states[j], batch(toks, d))
            losses.append(float(metrics["loss"]))
        assert np.isfinite(losses).all()
        assert losses[1] == pytest.approx(losses[0], rel=1e-5)


def test_mamba2_layer_at_full_width_on_the_card(dev):
    """One Mamba2 layer of zamba2-2.7b at full width (d 2 560, 80 heads of
    64, state 64, chunk 256), B 1, S 300 (a full chunk and a padded tail):
    the chunked forward within 1e-4 * max|y| of the token-by-token decode;
    the gradient of sum(y**2) through the chunked form finite, and within
    1e-3 relative L2 of the gradient through the decode recurrence."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    from repro_torch.models.common import tree_init
    cfg = get_config("zamba2-2.7b")
    gen = torch.Generator(device=dev).manual_seed(7)
    params = {k: v.detach().requires_grad_(True) for k, v in
              tree_init(ssm.mamba2_descs(cfg), gen).items()}
    keys = sorted(params)
    B, S = 1, 300
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    y, _ = ssm.mamba2_forward(params, x, cfg)
    g_chunk = torch.autograd.grad(torch.sum(y ** 2),
                                  [params[k] for k in keys])
    conv, state = ssm.mamba2_cache_shape(cfg, B)
    cache = ssm.MambaCache(torch.zeros(conv, device=dev),
                           torch.zeros(state, device=dev))
    ys = []
    for t in range(S):
        y_t, cache = ssm.mamba2_forward(params, x[:, t:t + 1], cfg,
                                        cache=cache)
        ys.append(y_t)
    y_rec = torch.cat(ys, dim=1)
    g_rec = torch.autograd.grad(torch.sum(y_rec ** 2),
                                [params[k] for k in keys])
    y, y_rec = y.detach(), y_rec.detach()
    assert float((y - y_rec).abs().max()) <= 1e-4 * float(y_rec.abs().max())
    for k, a, b in zip(keys, g_chunk, g_rec):
        assert bool(torch.isfinite(a).all()), k
        err = torch.linalg.vector_norm(a - b) / torch.clamp(
            torch.linalg.vector_norm(b), min=1e-30)
        assert float(err) < 1e-3, k


def test_encdec_decode_matches_full_forward_on_the_card(dev):
    """Reduced seamless: the encoder over 24 frames into a 24-slot cache,
    then 24 decode steps: within 1e-4 * max|logits| of the full
    ``encdec_forward`` on the card, and of the CPU's decode; ``enc_out``
    untouched."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("seamless-m4t-medium").reduced()
    cpu, card = _lm_params(cfg, 3, dev)
    B, T_ = 2, 24
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T_)))
    frames = torch.as_tensor(rng.standard_normal(
        (B, T_, cfg.d_model)).astype(np.float32))
    out = {}
    with torch.no_grad():
        for name, params, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            y, enc, _ = M.encdec_forward(params, cfg, frames.to(d),
                                         toks.to(d), remat="none")
            if name == "card":
                full = M.logits_fn(params, cfg, y).cpu()
            caches = M.init_cache(cfg, B, T_, torch.float32, device=d)
            caches["enc_out"].copy_(enc)
            steps = []
            for t in range(T_):
                logits, caches = M.forward_decode(
                    params, cfg, caches, toks[:, t:t + 1].to(d), t,
                    compute_dtype=torch.float32)
                steps.append(logits[:, 0].cpu())
            assert torch.equal(caches["enc_out"], enc)
            out[name] = torch.stack(steps, 1)
    tol = 1e-4 * float(full.abs().max())
    torch.testing.assert_close(out["card"], full, rtol=0, atol=tol)
    torch.testing.assert_close(out["card"], out["cpu"], rtol=0, atol=tol)


def test_vision_loss_on_the_card_masks_the_patches(dev):
    """Reduced llava, 16 patches and 48 tokens: ``forward_train``'s loss on
    the card within 1e-5 relative of a cross-entropy by hand over the text
    positions and of the CPU's loss; its gradients within 1e-4 relative
    L2 of the CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves
    cfg = get_config("llava-next-mistral-7b").reduced()
    pair = _lm_params(cfg, 4, dev)
    rng = np.random.default_rng(6)
    B, S, P = 2, 48, cfg.num_patches
    host = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (B, S))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (B, S))),
            "patches": torch.as_tensor(rng.standard_normal(
                (B, P, cfg.d_model)).astype(np.float32))}
    losses, grads = [], []
    for params, d in zip(pair, ("cpu", dev)):
        batch = {k: v.to(d) for k, v in host.items()}
        loss, _ = M.forward_train(params, cfg, batch, remat="none",
                                  compute_dtype=torch.float32)
        losses.append(float(loss))
        grads.append(torch.autograd.grad(loss, leaves(params)))
    with torch.no_grad():
        card, batch = pair[1], {k: v.to(dev) for k, v in host.items()}
        x = M.assemble_inputs(card, cfg, batch, torch.float32)
        x, _, _ = M.decoder_stack(card, x, torch.arange(P + S, device=dev),
                                  cfg, remat="none")
        logits = M.logits_fn(card, cfg, M.rms_norm(
            x, card["final_norm"], cfg.norm_eps))[:, P:]
        by_hand = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), batch["labels"].reshape(-1)))
    assert losses[1] == pytest.approx(by_hand, rel=1e-5)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip(*grads):
        err = torch.linalg.vector_norm(b.cpu() - a) / torch.clamp(
            torch.linalg.vector_norm(a), min=1e-30)
        assert float(err) < 1e-4


def _ep_rank(rank, world, init_file, out_path):
    """One rank of the expert-parallel card test: reduced granite's MoE
    layer on (data 1, model 2), its output and gradients to ``out_path``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_mod.lm_mesh({"data": 1, "model": 2})
        out = _ep_layer("cuda", mesh)
        torch.save({k: v.cpu() for k, v in out.items()},
                   f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def _ep_layer(dev, mesh):
    """Reduced granite's first MoE layer (E 8, k 2) on a seeded (4, 64, d)
    input at capacity factor 1.25: the output and the gradients of ``sum(y
    * R) + aux`` w.r.t. x, ``w_in`` and the router; with no mesh, the
    emulation of the (1, 2) expert-parallel layer (``moe_ffn_local`` over
    each shard's expert slice at the per-shard capacity, summed)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m").reduced()
    full = M.init_params(cfg, torch.Generator().manual_seed(5))
    p = {k: v.detach()[0].to(dev).requires_grad_()
         for k, v in full["blocks"]["l0"]["ffn"].items()}
    gen = torch.Generator().manual_seed(6)
    B, S, d = 4, 64, cfg.d_model
    x = torch.randn((B, S, d), generator=gen).to(dev).requires_grad_()
    R = torch.randn((B, S, d), generator=gen).to(dev)
    E, k, n_local = cfg.num_experts, cfg.experts_per_token, \
        cfg.num_experts // 2
    if mesh is not None:
        y, aux = moe.moe_forward(p, x, cfg, mesh=mesh, capacity_factor=1.25)
    else:
        idx, gw, aux = moe.router_topk(p, x, cfg)
        cap = max(min(int(np.ceil(B * S * k / 2 * 1.25)), B * S * k), 8)
        y = sum(moe.moe_ffn_local(
            x.reshape(-1, d), idx.reshape(-1, k), gw.reshape(-1, k),
            p["w_in"][m * n_local:(m + 1) * n_local],
            p["w_gate"][m * n_local:(m + 1) * n_local],
            p["w_out"][m * n_local:(m + 1) * n_local], e_lo=m * n_local,
            n_local=n_local, capacity=cap, act=cfg.mlp_act)
            for m in range(2)).reshape(B, S, d)
    gx, gw_in, gr = torch.autograd.grad((y * R).sum() + aux,
                                        [x, p["w_in"], p["router"]])
    return {"y": y.detach(), "aux": aux.detach(), "gx": gx, "gw_in": gw_in,
            "grouter": gr}


def test_expert_parallel_moe_on_two_ranks_on_the_card(dev, tmp_path):
    """Two ``gloo`` ranks sharing the card run reduced granite's MoE layer
    expert-parallel on (data 1, model 2), 4 experts a rank: each rank's
    output and its gradients w.r.t. x and the router, and its experts'
    ``w_in`` gradient, within 1e-5 x max|.| of the emulation on the card
    in this process."""
    import torch.multiprocessing as mp
    want = _ep_layer(dev, None)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_ep_rank, args=(
        r, 2, str(tmp_path / "rendezvous"), str(tmp_path / "out")))
        for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    for r in range(2):
        got = torch.load(tmp_path / f"out.{r}")
        es = slice(r * 4, (r + 1) * 4)
        assert rel(got["y"], want["y"].cpu()) <= 1e-5
        assert rel(got["gx"], want["gx"].cpu()) <= 1e-5
        assert rel(got["grouter"], want["grouter"].cpu()) <= 1e-5
        assert rel(got["gw_in"][es], want["gw_in"][es].cpu()) <= 1e-5
        assert float(got["gw_in"][4 - es.start:8 - es.start].abs().max()) \
            == 0.0
        assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6
