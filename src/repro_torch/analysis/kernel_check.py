"""Kernel audit of the port: the semantic checks of
``repro.analysis.pallas_check``, held against the wrappers of
``kernels/ops.py``: the five flat ones and the reference's three padded
entry points (``screen_norms``, ``screen_norms_batched``,
``sgl_prox_padded``), each under its kernel's name.

* ``kernels/mask-coverage``: 1e30 is written into every slot a kernel
  must not read (the masked-out slots of the padded group view, and the
  one extra column they point at), on ragged shapes that are multiples of
  no tile, and each wrapper must match its plain version in
  ``kernels/ref.py`` on the clean data: finite, ``snorm2`` and the prox
  within rtol = atol = 1e-5, ``cinf`` and the DPC keep mask exactly, the
  prox's uncovered columns exactly 0, ``xtv`` within ``2 N eps sum|x v|``
  a column (the tolerances of ``chip_smoke.py``'s kernel phase).  On the
  CPU the wrappers are those plain versions, so the check proves little
  there beyond catching a wrapper that reads a masked slot; it proves the
  kernels on the card (``mask_coverage("cuda")``).
* ``kernels/f64-gate``: the grid screens must refuse ``use_kernels=True``
  on float64 with ``TypeError``, not round it through float32.
* ``kernels/no-kernel`` (warning): a wrapper that mask coverage called
  reached no kernel: on the card it launched nothing
  (``ops.launch_counts``), on the CPU it did not dispatch its
  ``repro_torch`` operator under a counter.  Registry drift.

The reference's ``pallas/lane-misaligned`` becomes mask coverage's ragged
shapes (a multiple of no tile: each kernel masks its own tail) and
``pallas/f64-aval`` the trace lint's ``trace/kernel-on-f64``.
``pallas/block-divisibility`` has no counterpart: it reads the
``BlockSpec``s of a traced ``pallas_call``, and a CUDA kernel has none (it
computes its offsets from its block index and bounds-checks its threads).
"""
from __future__ import annotations

import numpy as np
import torch

from .findings import Finding

POISON = 1e30
RAGGED_SIZES = (3, 7, 1, 5, 4, 9, 2, 6)          # p = 37, G = 8
EPS32 = float(np.finfo(np.float32).eps)


def _ragged_spec(device):
    from ..core.groups import GroupSpec
    return GroupSpec.from_sizes(list(RAGGED_SIZES), device=device)


def mask_coverage(device=None, errors: dict = None) -> list:
    """Each wrapper on poisoned padding against its plain version on the
    clean data, on ``device`` (None: the card, raising without CUDA).
    ``errors`` (a dict), when given, receives each kernel's largest
    absolute difference."""
    from ..core.groups import resolve_device
    from ..kernels import ops, ref

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(1)
    findings = []
    spec = _ragged_spec(dev)
    G, n_max = spec.pad_index.shape
    p = spec.num_features
    mask = spec.pad_mask

    def rand(*shape, scale=2.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def compare(name, got, want, *, exact=False, tol=None, entry=None):
        """``entry``: the wrapper's name where it is not the kernel's."""
        finite = bool(torch.isfinite(got.float()).all())
        diff = (got.float() - want.float()).abs()
        err = float(diff.max()) if finite else float("inf")
        if errors is not None:
            errors[name] = max(errors.get(name, 0.0), err)
        if exact:
            ok = torch.equal(got, want)
        elif tol is not None:
            ok = bool((diff <= tol).all())
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
        if not (finite and ok):
            findings.append(Finding(
                "kernels/mask-coverage", "error", f"kernels.{entry or name}",
                f"on {dev}, {entry or name} under 1e30 in its masked slots "
                f"differs "
                f"from its plain version on clean data (max|diff| = "
                f"{err:.3g}): a masked slot or a tail is read"))

    # screen_norms: C (R, p + 1), every masked slot points at the poisoned
    # column p
    C = rand(5, p + 1)
    C[:, p] = POISON
    idx = torch.where(mask, spec.pad_index, p).contiguous()
    got = ops.screen_norms_gather(C, idx, mask)
    want = ref.screen_norms_gather_ref(C[:, :p].contiguous(),
                                       spec.pad_index, mask)
    compare("screen_norms", got[0], want[0])
    compare("screen_norms", got[1], want[1], exact=True)

    # the reference's padded entry points: the (G, n_max) layout and the
    # (L, G, n_max) grid, poison in every masked slot
    vals = rand(5, G, n_max)
    poisoned = torch.where(mask, vals, POISON)
    clean = torch.where(mask, vals, 0.0)
    want = ref.screen_norms_folds_ref(clean, mask)
    got = ops.screen_norms(poisoned[0], mask)
    compare("screen_norms", got[0], want[0][0])
    compare("screen_norms", got[1], want[1][0], exact=True)
    got = ops.screen_norms_batched(poisoned, mask)
    compare("screen_norms", got[0], want[0], entry="screen_norms_batched")
    compare("screen_norms", got[1], want[1], exact=True,
            entry="screen_norms_batched")

    # screen_norms_folds: (K, L, G, n_max), poison in every masked slot
    vals = rand(3, 5, G, n_max)
    poisoned = torch.where(mask, vals, POISON)
    clean = torch.where(mask, vals, 0.0)
    got = ops.screen_norms_folds(poisoned, mask)
    want = ref.screen_norms_folds_ref(clean.reshape(15, G, n_max), mask)
    compare("screen_norms_folds", got[0].reshape(15, G), want[0])
    compare("screen_norms_folds", got[1].reshape(15, G), want[1])

    # dpc_screen_folds pads (L, p) itself: no poison surface, but the
    # ragged (K, L, p) = (2, 3, 37) runs the tail lanes; exact
    Cd = rand(2, 3, p, scale=0.5) + 0.6
    radii = torch.rand(2, 3, generator=gen).to(dev)
    col_n = (torch.rand(2, p, generator=gen) + 0.5).to(dev)
    compare("dpc_screen_folds", ops.dpc_screen_folds(Cd, radii, col_n),
            ref.dpc_screen_folds_ref(Cd, radii, col_n), exact=True)

    # sgl_prox on the flat vector: the masked slots point at one more,
    # uncovered column holding 1e30, which must come out 0
    v = rand(p + 1)
    v[p] = POISON
    unc = torch.cat([spec.pad_uncovered,
                     torch.ones(1, dtype=torch.bool, device=dev)])
    t_l1 = torch.tensor([0.3], device=dev)
    t_group = (torch.rand(G, generator=gen) + 0.1).to(dev)
    got = ops.sgl_prox(v, idx, mask, unc, t_l1, t_group)
    want = torch.cat([ref.sgl_prox_flat_ref(v[:p].contiguous(),
                                            spec.pad_index, mask, t_l1,
                                            t_group),
                      torch.zeros(1, device=dev)])
    compare("sgl_prox", got, want)
    compare("sgl_prox", got[unc], torch.zeros_like(got[unc]), exact=True)

    # sgl_prox_padded: the (G, n_max) layout, poison in every masked slot
    vals = rand(G, n_max)
    got = ops.sgl_prox_padded(torch.where(mask, vals, POISON), mask, 0.3,
                              t_group)
    want = ref.sgl_prox_ref(torch.where(mask, vals, 0.0), mask, t_l1,
                            t_group)
    compare("sgl_prox", got, want, entry="sgl_prox_padded")
    compare("sgl_prox", got[~mask], torch.zeros_like(got[~mask]),
            exact=True, entry="sgl_prox_padded")

    # xtv pads (N, p) itself; ragged (137, 37) runs the tail path
    X = rand(137, p, scale=1.0)
    w = rand(137, scale=1.0)
    bound = 2 * 137 * EPS32 * (X.abs() * w.abs()[:, None]).sum(dim=0)
    compare("xtv", ops.xtv(X, w), ref.xtv_ref(X, w), tol=bound + 1e-30)
    return findings


def f64_gate() -> list:
    """``use_kernels=True`` on float64 must raise ``TypeError`` at the grid
    screens, not round the statistics through the float32 kernels."""
    from ..core import dpc as _dpc
    from ..core import screening as _scr

    findings = []
    gen = torch.Generator().manual_seed(2)
    spec = _ragged_spec("cpu")
    p = spec.num_features
    f64 = torch.float64
    X = torch.randn(6, p, generator=gen, dtype=f64)
    y = torch.randn(6, generator=gen, dtype=f64)
    lams = torch.tensor([1.0, 0.5], dtype=f64)
    vec_p = torch.ones(p, dtype=f64)
    vec_g = torch.ones(spec.num_groups, dtype=f64)
    Y = torch.stack([y, y])
    lams_k = torch.stack([lams, lams])
    vec_pk = torch.ones(2, p, dtype=f64)
    vec_gk = torch.ones(2, spec.num_groups, dtype=f64)

    gates = [
        ("screening.tlfre_screen_grid",
         lambda: _scr.tlfre_screen_grid(X, y, spec, 0.9, lams, 1.0, y, y,
                                        vec_p, vec_g, use_kernels=True)),
        ("screening.tlfre_screen_grid_folds",
         lambda: _scr.tlfre_screen_grid_folds(X, Y, spec, 0.9, lams_k, Y,
                                              Y, vec_pk, vec_gk,
                                              use_kernels=True)),
        ("dpc.dpc_screen_grid_folds",
         lambda: _dpc.dpc_screen_grid_folds(X, Y, lams_k, Y, Y, vec_pk,
                                            use_kernels=True)),
    ]
    for name, call in gates:
        try:
            call()
        except TypeError:
            continue               # the gate fired
        except Exception as exc:
            findings.append(Finding(
                "kernels/f64-gate", "error", name,
                f"{name} with use_kernels=True on float64 raised "
                f"{type(exc).__name__} instead of TypeError: {exc}"))
        else:
            findings.append(Finding(
                "kernels/f64-gate", "error", name,
                f"{name} accepted use_kernels=True on float64 inputs: the "
                f"float32-only kernel gate is broken"))
    return findings


def run(device=None) -> list:
    """The three checks (``device=None`` is the card).  On the card the
    wrappers run as the engines call them and each must have launched its
    kernel; on the CPU they run under a counter and each must have
    dispatched its operator."""
    from ..core.groups import resolve_device
    from ..kernels import ops
    from ..launch.cost_analysis import CostCounter
    dev = resolve_device(device)
    if dev.type == "cuda":
        before = ops.launch_counts()
        found = mask_coverage(dev)
        reached = {n: k - before[n] for n, k in ops.launch_counts().items()}
        how = "launched nothing"
    else:
        with CostCounter(memory=False) as c:
            found = mask_coverage(dev)
        reached = c.kernel_calls
        how = "did not dispatch its operator"
    found += [Finding(
        "kernels/no-kernel", "warning", f"kernels.{name}",
        f"the {name} wrapper {how} under mask coverage on {dev} (registry "
        f"drift)") for name in ops.KERNELS if not reached.get(name)]
    return found + f64_gate()
