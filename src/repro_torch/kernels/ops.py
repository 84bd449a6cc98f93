"""Dispatching wrappers around the five CUDA kernels.

A tensor on the CPU takes the kernel's plain PyTorch version (``ref``); a
tensor on a CUDA device launches the kernel, which raises on anything it
does not take.  There is no fallback between the two.

The engines call the flat wrappers, which read the group spec's padded
view through ``pad_index``.  The reference's padded-layout entry points
(``screen_norms``, ``screen_norms_batched``, ``sgl_prox_padded``) take the
(G, n_max) layout itself and reach the same two kernels through an identity
``pad_index``; they count as launches of those kernels.

Every kernel is float32-only: the path engine engages them only for
float32 problems (``path_engine._kernels_active``), and the screening entry
point raises ``TypeError`` on float64 with kernels requested.

Each kernel is also an operator of the ``repro_torch`` namespace
(``torch.library.custom_op``) whose fake implementation returns empty
outputs of the kernel's shapes and dtypes.  A wrapper calls that operator
only where the dispatcher is watched: on a fake tensor, or under a
``TorchDispatchMode`` (``FakeTensorMode``, ``launch.cost_analysis``'s
counter), which then sees the kernel as one operator with its inputs and
outputs and never hands a fake tensor to the compiled library.  Elsewhere
the wrapper calls its kernel directly, without the operator's Python
dispatch.
"""
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from . import dpc_screen_folds as _dpc_screen_folds
from . import ref
from . import screen_norms as _screen_norms
from . import screen_norms_folds as _screen_norms_folds
from . import sgl_prox as _sgl_prox
from . import xtv as _xtv

KERNELS = {"xtv": _xtv, "screen_norms": _screen_norms, "sgl_prox": _sgl_prox,
           "screen_norms_folds": _screen_norms_folds,
           "dpc_screen_folds": _dpc_screen_folds}


def launch_counts() -> dict:
    """{kernel name: launches in this process}."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def captured_counts() -> dict:
    """{kernel name: calls recorded into CUDA graphs in this process}.  A
    wrapper called under stream capture launches nothing and counts here;
    the graph's replays launch it."""
    return {name: mod.captured for name, mod in KERNELS.items()}


def count_replay(recorded: dict) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``recorded`` ({kernel name: calls}, a difference of two
    ``captured_counts``)."""
    for name, n in recorded.items():
        KERNELS[name].launches += n


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _traced(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` goes through the registered operator."""
    return isinstance(t, FakeTensor) or \
        _get_current_dispatch_mode() is not None


# -- each kernel called directly, and as an operator -----------------------

def _op(name: str, direct, fake):
    """``direct`` registered as the operator ``repro_torch::<name>``, with
    ``fake`` as its fake implementation."""
    op = torch.library.custom_op(f"repro_torch::{name}", direct,
                                 mutates_args=())
    op.register_fake(fake)
    return op


def _run_xtv(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return ref.xtv_ref(X, v) if _on_cpu(X) else _xtv.xtv_cuda(X, v)


def _run_screen_norms(C: torch.Tensor, pad_index: torch.Tensor,
                  pad_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(C):
        return ref.screen_norms_gather_ref(C, pad_index, pad_mask)
    return _screen_norms.screen_norms_cuda(C, pad_index, pad_mask)


def _run_screen_norms_folds(c_pad: torch.Tensor, mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(c_pad):
        return ref.screen_norms_folds_ref(c_pad, mask)
    return _screen_norms_folds.screen_norms_folds_cuda(c_pad, mask)


def _run_dpc_screen_folds(C: torch.Tensor, radii: torch.Tensor,
                      col_norms_f: torch.Tensor) -> torch.Tensor:
    if _on_cpu(C):
        return ref.dpc_screen_folds_ref(C, radii, col_norms_f)
    return _dpc_screen_folds.dpc_screen_folds_cuda(C, radii, col_norms_f)


def _run_sgl_prox(v: torch.Tensor, pad_index: torch.Tensor,
              pad_mask: torch.Tensor, uncovered: torch.Tensor,
              t_l1: torch.Tensor, t_group: torch.Tensor) -> torch.Tensor:
    if _on_cpu(v):
        return ref.sgl_prox_flat_ref(v, pad_index, pad_mask, t_l1, t_group)
    return _sgl_prox.sgl_prox_cuda(v, pad_index, pad_mask, uncovered, t_l1,
                                   t_group)


def _two_f32(t, shape):
    return (t.new_empty(shape, dtype=torch.float32),
            t.new_empty(shape, dtype=torch.float32))


OPS = {
    "xtv": _op("xtv", _run_xtv, lambda X, v: X.new_empty(
        X.shape[1], dtype=torch.float32)),
    "screen_norms": _op("screen_norms", _run_screen_norms,
                        lambda C, idx, mask: _two_f32(
                            C, (C.shape[0], idx.shape[0]))),
    "screen_norms_folds": _op("screen_norms_folds", _run_screen_norms_folds,
                              lambda c, mask: _two_f32(c, c.shape[:2])),
    "dpc_screen_folds": _op("dpc_screen_folds", _run_dpc_screen_folds,
                            lambda C, r, cn: C.new_empty(
                                C.shape, dtype=torch.bool)),
    "sgl_prox": _op("sgl_prox", _run_sgl_prox,
                    lambda v, *rest: v.new_empty(v.shape)),
}


# -- the wrappers ------------------------------------------------------------

def xtv(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out = X^T v, float32.  The certification GEMV."""
    return (OPS["xtv"] if _traced(X) else _run_xtv)(X, v)


def screen_norms_gather(C: torch.Tensor, pad_index: torch.Tensor,
                        pad_mask: torch.Tensor):
    """C (R, p) read through the padded view ``pad_index`` / ``pad_mask``
    (G, n_max) -> (||S_1(c)||^2 (R, G), ||c||_inf (R, G)) float32, masked
    slots as 0.  The grid screen's group statistics: the lambda rows of the
    screen GEMM's output, never copied into the padded layout."""
    return (OPS["screen_norms"] if _traced(C) else _run_screen_norms)(
        C, pad_index, pad_mask)


def _identity_index(mask: torch.Tensor) -> torch.Tensor:
    """The padded layout read as itself: slot (g, k) is column g*n_max+k."""
    return torch.arange(mask.numel(), device=mask.device).reshape(mask.shape)


def screen_norms(c_pad: torch.Tensor, mask: torch.Tensor):
    """The reference's padded entry point: c_pad (G, n_max) with its mask
    -> (||S_1(c_g)||^2 (G,), ||c_g||_inf (G,)) float32, masked slots as 0.
    The ``screen_norms`` kernel reads c_pad as one row through an identity
    ``pad_index``."""
    snorm2, cinf = screen_norms_batched(c_pad[None], mask)
    return snorm2[0], cinf[0]


def screen_norms_batched(c_pad_grid: torch.Tensor, mask: torch.Tensor):
    """The reference's grid entry point: c_pad_grid (L, G, n_max) with a
    shared (G, n_max) mask -> ((L, G), (L, G)) float32, masked slots as 0.
    The ``screen_norms`` kernel reads the L rows of the padded grid through
    an identity ``pad_index``."""
    if c_pad_grid.ndim != 3 or c_pad_grid.shape[1:] != mask.shape:
        raise ValueError(f"c_pad_grid {tuple(c_pad_grid.shape)} is not "
                         f"(L, *mask.shape) for mask {tuple(mask.shape)}")
    L, G, n_max = c_pad_grid.shape
    C = c_pad_grid.reshape(L, G * n_max).contiguous()
    mask = mask.contiguous()
    return (OPS["screen_norms"] if _traced(C) else _run_screen_norms)(
        C, _identity_index(mask), mask)


def screen_norms_folds(c_pad_folds: torch.Tensor, mask: torch.Tensor):
    """c_pad_folds (K, L, G, n_max) with a shared (G, n_max) mask ->
    (||S_1(c)||^2 (K, L, G), ||c||_inf (K, L, G)) float32: every fold x
    lambda row of the stacked CV screen in one pass."""
    K, L, G, n_max = c_pad_folds.shape
    flat = c_pad_folds.reshape(K * L, G, n_max)
    snorm2, cinf = (OPS["screen_norms_folds"] if _traced(flat)
                    else _run_screen_norms_folds)(flat, mask)
    return snorm2.reshape(K, L, G), cinf.reshape(K, L, G)


def dpc_screen_folds(C: torch.Tensor, radii: torch.Tensor,
                     col_norms_f: torch.Tensor) -> torch.Tensor:
    """Fused fold-stacked DPC rule: C (K, L, p), radii (K, L), col_norms_f
    (K, p) -> feat_keep (K, L, p) bool, float32 compute."""
    return (OPS["dpc_screen_folds"] if _traced(C)
            else _run_dpc_screen_folds)(C, radii, col_norms_f)


def sgl_prox(v: torch.Tensor, pad_index: torch.Tensor,
             pad_mask: torch.Tensor, uncovered: torch.Tensor,
             t_l1: torch.Tensor, t_group: torch.Tensor) -> torch.Tensor:
    """Fused SGL prox on the flat vector v (p,) through the padded view
    ``pad_index`` / ``pad_mask`` (G, n_max); ``uncovered`` (p,) marks the
    columns that no valid slot covers, which come out 0.  ``t_l1`` is a
    1-element tensor on the operands' device.  float32 on the card; the
    plain version keeps v's dtype at its boundary."""
    return (OPS["sgl_prox"] if _traced(v) else _run_sgl_prox)(
        v, pad_index, pad_mask, uncovered, t_l1, t_group)


def sgl_prox_padded(v_pad: torch.Tensor, mask: torch.Tensor, t_l1,
                    t_group) -> torch.Tensor:
    """The reference's padded entry point: the fused SGL prox on v_pad
    (G, n_max) with its mask, ``t_l1`` a scalar, ``t_group`` (G,) -> the
    padded prox output (G, n_max) float32, masked slots 0.  The ``sgl_prox``
    kernel reads v_pad as a flat vector through an identity ``pad_index``,
    every masked slot an uncovered column."""
    if v_pad.shape != mask.shape:
        raise ValueError(f"v_pad {tuple(v_pad.shape)} is not mask's shape "
                         f"{tuple(mask.shape)}")
    v = v_pad.reshape(-1).contiguous()
    mask = mask.contiguous()
    dev = v.device
    t_l1 = torch.as_tensor(t_l1, dtype=torch.float32, device=dev).reshape(1)
    t_group = torch.as_tensor(t_group, dtype=torch.float32, device=dev)
    out = (OPS["sgl_prox"] if _traced(v) else _run_sgl_prox)(
        v, _identity_index(mask), mask, ~mask.reshape(-1), t_l1, t_group)
    return out.reshape(mask.shape).to(torch.float32)
