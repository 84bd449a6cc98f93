"""The port's root examples (``repro_torch.examples``) against the
reference's library calls, made in the sequence and with the arguments of
the reference scripts (``examples/*.py``), at reduced sizes: the
quickstart, the nonnegative Lasso, the logistic path and the LM server
here; the two model-selection examples in
``tests/test_torch_examples_selection.py``.

The reference scripts run with JAX's x64 off, so they compute in float32
even where they build float64 data.  ``tests/conftest.py`` turns x64 on for
the whole suite, so each reference run here sits inside
``jax.enable_x64(False)`` and takes the float32 numpy inputs that the
port's example builds (the port's own runs ask for float32 explicitly).
The one float64 case (the quickstart) runs the reference with x64 on.

Bars: betas within ``1e-5 * max|beta|`` at float32 (1e-8 at float64),
kept counts and the by-hand grid's choice equal, the classifier's
probabilities within 1e-5.  The LM server draws its weights from torch's
generator, so ``serve_batched`` is held to its output's shape and
statistics only.
"""
import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro import api as japi
from repro_torch.examples import (cv_model_selection, nonneg_lasso_dpc,
                                  quickstart, serve_batched,
                                  session_refinement, sgl_logistic)

F32 = 1e-5
F64 = 1e-8


def _close(got, want, bar, scale=None):
    """|got - want| <= bar * max|want| (or ``bar * scale``)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    if scale is None:
        scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= bar * scale


def _same_path(got, want, bar, groups=True):
    _close(got.betas, want.betas, bar)
    np.testing.assert_allclose(got.lambdas, np.asarray(want.lambdas),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.kept_features,
                                  np.asarray(want.kept_features))
    if groups:
        np.testing.assert_array_equal(got.kept_groups,
                                      np.asarray(want.kept_groups))


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


# -- the reference scripts' data recipes, line for line ----------------------

def _quickstart_data(N, G, n):
    rng = np.random.default_rng(0)
    p = G * n
    X = rng.standard_normal((N, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    for g in rng.choice(G, G // 10, replace=False):
        idx = g * n + rng.choice(n, n // 10 + 1, replace=False)
        beta_true[idx] = rng.standard_normal(len(idx))
    y = (X @ beta_true + 0.01 * rng.standard_normal(N)).astype(np.float32)
    return X, y


def _cv_data(N, G, n):
    rng = np.random.default_rng(0)
    p = G * n
    X = rng.standard_normal((N, p))
    beta_true = np.zeros(p)
    true_groups = rng.choice(G, G // 10, replace=False)
    for g in true_groups:
        idx = g * n + rng.choice(n, 3, replace=False)
        beta_true[idx] = rng.standard_normal(3)
    y = X @ beta_true + 0.5 * rng.standard_normal(N)
    return X, y, beta_true, true_groups


def test_data_recipes_are_the_reference_scripts():
    for got, want in ((quickstart.data(60, 20, 5), _quickstart_data(60, 20, 5)),
                      (cv_model_selection.data(90, 12, 5),
                       _cv_data(90, 12, 5))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    X, y = nonneg_lasso_dpc.data(60, 150, 8)
    assert X.dtype == y.dtype == np.float32 and X.shape == (60, 150)
    assert serve_batched.SERVE_ARGV == _reference_serve_argv()


def _reference_serve_argv():
    """The argument list that ``examples/serve_batched.py`` hands
    ``serve.main``, read from the script's syntax tree."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "serve_batched.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and ast.unparse(node.func) == "serve.main"]
    assert len(calls) == 1
    return ast.literal_eval(calls[0].args[0])


# -- quickstart -------------------------------------------------------------

QS = dict(N=60, G=20, n=5, n_lambdas=12)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, F32),
                                       (torch.float64, F64)])
def test_quickstart_matches_reference(dtype, bar):
    out = quickstart.run(**QS, device="cpu", dtype=dtype)
    X, y = quickstart.data(QS["N"], QS["G"], QS["n"])
    spec = J.GroupSpec.uniform_groups(QS["G"], QS["n"])
    kw = quickstart.plan_kwargs(QS["n_lambdas"])
    f64 = dtype == torch.float64
    if f64:
        X, y = X.astype(np.float64), y.astype(np.float64)
    with jax.enable_x64(f64):
        res = J.SGLSession(J.Problem.sgl(X, y, spec)).path(
            J.Plan(alpha=1.0, **kw))
        legacy = J.sgl_path(X, y, spec, 1.0, **kw)
        base = J.sgl_path(X, y, spec, 1.0, screen="none", **kw)
    for got, want in ((out["res"], res), (out["legacy"], legacy),
                      (out["base"], base)):
        _same_path(got, want, bar)
        assert got.betas.dtype == np.float64 or not f64
    assert out["res"].lam_max == pytest.approx(res.lam_max, rel=1e-6)
    assert out["round_trips"] == res.stats.n_segments + res.stats.n_screens
    assert (out["res"].stats.n_segments, out["res"].stats.n_screens) == \
        (res.stats.n_segments, res.stats.n_screens)
    assert set(out["walls"]) == {"engine", "legacy", "baseline"}
    assert out["agree"] <= 1e-3 * np.max(np.abs(base.betas))


def test_quickstart_report_prints_the_reference_lines(capsys):
    out = quickstart.run(**QS, device="cpu")
    quickstart.report(out)
    text = capsys.readouterr().out
    for words in ("lambda_max =", "kept features (of 100)",
                  "max |beta_engine - beta_baseline|",
                  "engine host round-trips", "batched engine:",
                  "legacy driver :", "baseline path :",
                  "SPEEDUP vs baseline"):
        assert words in text


# -- nonneg_lasso_dpc --------------------------------------------------------

def test_nonneg_lasso_dpc_matches_reference(capsys):
    out = nonneg_lasso_dpc.run(N=60, p=150, n_hot=8, n_lambdas=12,
                               device="cpu")
    X, y = nonneg_lasso_dpc.data(60, 150, 8)
    with jax.enable_x64(False):
        res = J.nn_lasso_path(X, y, n_lambdas=12, tol=1e-6, safety=1e-6,
                              max_iter=6000, check_every=50,
                              engine="batched")
        base = J.nn_lasso_path(X, y, n_lambdas=12, tol=1e-6, screen="none",
                               max_iter=6000, check_every=50)
    _same_path(out["res"], res, F32, groups=False)
    _same_path(out["base"], base, F32, groups=False)
    assert out["round_trips"] == res.stats.n_segments + res.stats.n_screens
    assert np.all(out["res"].betas >= 0.0)
    nonneg_lasso_dpc.report(out)
    assert "atoms entering solver (of 150)" in capsys.readouterr().out


# -- sgl_logistic ------------------------------------------------------------

LG = dict(N=100, G=12, n=5, n_lambdas=8)


def test_sgl_logistic_matches_reference(capsys):
    pytest.importorskip("sklearn")
    out = sgl_logistic.run(**LG, device="cpu")
    X, y, rng = sgl_logistic.data(LG["N"], LG["G"], LG["n"])
    X, y = _f32(X, y)
    G, n = LG["G"], LG["n"]
    spec = J.GroupSpec.uniform_groups(G, n)
    kw = sgl_logistic.plan_kwargs(LG["n_lambdas"])
    with jax.enable_x64(False):
        session = J.SGLSession(J.Problem.sgl_logistic(X, y, spec))
        res = session.path(J.Plan(screen="gapsafe", **kw))
        base = session.path(J.Plan(screen="none", **kw))
        wspec = J.GroupSpec.from_sizes(
            [n] * G, weights=rng.uniform(0.5, 2.0, G),
            feature_weights=rng.uniform(0.5, 2.0, G * n))
        wres = J.SGLSession(J.Problem.sgl_logistic(X, y, wspec)).path(
            J.Plan(screen="gapsafe", **kw))
        lam = 0.2 * res.lam_max
        clf = japi.SGLClassifier(lam=lam, alpha=0.9, groups=[n] * G).fit(X, y)
        proba = np.asarray(clf.predict_proba(X[:5]))
        best, score, scores = sgl_logistic.grid_by_hand(
            japi.SGLClassifier(alpha=0.9, groups=[n] * G), X, y,
            [0.5 * res.lam_max, 0.2 * res.lam_max])
    _same_path(out["res"], res, F32)
    _same_path(out["base"], base, F32)
    _same_path(out["wres"], wres, F32)
    _close(out["clf"].coef_, clf.coef_, F32)
    assert out["clf"].kept_features_ == clf.kept_features_
    assert out["accuracy"] == pytest.approx(float(clf.score(X, y)))
    np.testing.assert_allclose(out["proba"], proba, atol=1e-5)
    got_best, got_score, got_scores = out["grid"]
    assert got_best == pytest.approx(best, rel=1e-6)
    np.testing.assert_allclose(got_scores, scores)
    sgl_logistic.report(out)
    assert "two-fold grid by hand" in capsys.readouterr().out


# -- serve_batched, the CLIs, the imports --------------------------------------

def test_serve_batched_on_the_cpu(capsys):
    """The example is ``serve.main`` at the reference script's arguments
    (``test_data_recipes_are_the_reference_scripts`` reads them from the
    script).  The parity of ``serve.main``'s model with the reference's is
    held elsewhere, on the reduced config that ``--smoke`` builds:
    ``tests/test_torch_lm_model.py::test_forward_train_matches_reference``
    (gemma2-2b's forward against the reference's, on the reference's
    weights) and ``test_decode_matches_full_forward_past_the_window``
    (gemma2-2b's decode through a 64-slot cache, as here, against the
    reference's forward)."""
    lat = []
    gen = serve_batched.main(["--device", "cpu"], latencies=lat)
    assert gen.shape == (8, 24) and len(lat) == 24
    text = capsys.readouterr().out
    assert "per-step p50=" in text and "warm throughput" in text


@pytest.mark.parametrize("module", [quickstart, nonneg_lasso_dpc,
                                    cv_model_selection, session_refinement,
                                    sgl_logistic, serve_batched])
def test_examples_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_examples_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.examples.quickstart, "
            "repro_torch.examples.nonneg_lasso_dpc, "
            "repro_torch.examples.cv_model_selection, "
            "repro_torch.examples.session_refinement, "
            "repro_torch.examples.sgl_logistic, "
            "repro_torch.examples.serve_batched\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": src, "PATH": os.environ["PATH"]})
