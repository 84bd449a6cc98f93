"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one.  The file
imports no JAX, so it runs on a machine that has only PyTorch; there, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's ``conftest.py`` imports JAX).

Tolerances as in ``tests/test_torch_kernels.py``: rtol = atol = 1e-5 for
the per-row statistics and the prox, ``2 * N * eps * sum|x_ij v_i|`` per
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


@pytest.mark.parametrize("N,p", [(1, 1), (250, 10_000), (300, 1037)])
def test_xtv_kernel_matches_plain(dev, N, p):
    from repro_torch.kernels import ref
    from repro_torch.kernels.xtv import xtv_cuda
    gen = torch.Generator().manual_seed(N + p)
    X = torch.randn(N, p, generator=gen).to(dev)
    v = torch.randn(N, generator=gen).to(dev)
    got = xtv_cuda(X, v)
    want = ref.xtv_ref(X, v)
    torch.cuda.synchronize()
    bound = N * EPS32 * (X.abs() * v.abs()[:, None]).sum(dim=0)
    assert bool(((got - want).abs() <= 2 * bound + 1e-30).all())


@pytest.mark.parametrize("L,G,n_max", [(1, 1, 1), (4, 37, 9), (128, 100, 10),
                                       (3, 50, 70)])
def test_screen_norms_kernel_matches_plain(dev, L, G, n_max):
    from repro_torch.kernels import ref
    from repro_torch.kernels.screen_norms import screen_norms_cuda
    gen = torch.Generator().manual_seed(L * G * n_max)
    mask = _mask(gen, G, n_max)
    clean, poison = _poisoned(gen, L * G, mask, dev)
    mask = mask.to(dev)
    for a, b in zip(screen_norms_cuda(poison, mask),
                    ref.screen_norms_ref(clean, mask)):
        torch.cuda.synchronize()
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("G,n_max,t_l1", [(1, 1, 0.0), (37, 9, 0.3),
                                          (1000, 10, 1.1), (20, 130, 0.05)])
def test_sgl_prox_kernel_matches_plain(dev, G, n_max, t_l1):
    from repro_torch.kernels import ref
    from repro_torch.kernels.sgl_prox import sgl_prox_cuda
    gen = torch.Generator().manual_seed(G * n_max)
    mask = _mask(gen, G, n_max)
    clean, poison = _poisoned(gen, G, mask, dev)
    mask = mask.to(dev)
    tl1 = torch.tensor([t_l1], device=dev)
    tg = (torch.rand(G, generator=gen) * 2).to(dev)
    got = sgl_prox_cuda(poison, mask, tl1, tg)
    torch.cuda.synchronize()
    assert bool((got[~mask] == 0).all())
    torch.testing.assert_close(got, ref.sgl_prox_ref(clean, mask, tl1, tg),
                               **TOL)


def test_kernels_refuse_other_dtypes_and_layouts(dev):
    from repro_torch.kernels.xtv import xtv_cuda
    X = torch.randn(8, 16, device=dev)
    with pytest.raises(TypeError):
        xtv_cuda(X.double(), torch.randn(8, device=dev).double())
    with pytest.raises(ValueError, match="contiguous"):
        xtv_cuda(X.T, torch.randn(16, device=dev))


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
    assert all(n > 0 for n in counts.values()), counts
    assert res.stats.n_pallas_screens == res.stats.n_screens > 0
    cpu = T.SGLSession(T.Problem.sgl(X, y, [6] * 20, device="cpu")).path(
        T.Plan(n_lambdas=8, tol=1e-6, safety=1e-6, min_bucket=16,
               use_kernels=True))
    np.testing.assert_allclose(res.betas, cpu.betas, atol=1e-4)
