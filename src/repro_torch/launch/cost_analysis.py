"""What a step costs, counted from its ATen operators (the counterpart of
``repro.launch.hlo_analysis``).

The reference re-derives FLOPs, HBM bytes and collective traffic from XLA's
optimised HLO text.  PyTorch runs eagerly, so the port counts the operators
themselves: ``CostCounter`` is a ``TorchDispatchMode`` that sees every ATen
operator a step runs, on real tensors or on fake ones
(``torch._subclasses.FakeTensorMode``, which has no data and allocates
nothing), and reports

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, the attention operators, convolutions), plus
  ``2 * M * N`` for the matrix-vector products it does not count (``mv``,
  ``addmv``, ``dot``, ``vdot``), and the kernels' own counts;
* **bytes moved**: each operator reads its tensor inputs and writes its
  outputs once.  An eager operator is one kernel, so there is no fusion
  credit (the reference's fusion boundaries have no counterpart); views
  and in-place results move nothing new;
* **the peak of live bytes**: every storage an operator creates is
  charged from its creation until the last tensor that shares it is
  collected (tracked through weak references), rounded up to the caching
  allocator's 512-byte blocks.  Storages made before the counter started
  (parameters, inputs) are not charged: the peak is above them;
* **collectives by kind** (``torch.distributed``'s ``c10d`` operators), with
  their payload bytes and the reference's ring model of the bytes each rank
  puts on the wire.

The CUDA kernels of ``kernels/ops.py`` are operators of the
``repro_torch`` namespace wherever a dispatch mode is in force: each call is
counted as one kernel (``kernel_calls``) that reads its inputs and writes
its outputs once, with the FLOPs of ``KERNEL_FLOPS``.

``roofline_terms`` turns a count into times on the H100 SXM (NVIDIA's data
sheet, as the ``hopper-kernels`` guide gives it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ---------------------------------------------------------------------------
# the card (NVIDIA H100 SXM, dense rates without sparsity, at its 700 W limit)
# ---------------------------------------------------------------------------

DEVICE_NAME = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12          # device memory
F32_FLOPS = 67e12                  # float32 outside the tensor cores
TF32_FLOPS = 495e12                # tensor cores, TF32
BF16_FLOPS = 989e12                # tensor cores, bf16 / fp16
LINK_BYTES_PER_S = 450e9           # NVLink, each way
#: the card's ``torch.cuda.get_device_properties(0).total_memory``, read on
#: an H100 80GB HBM3 at a 700 W power limit (torch 2.11, CUDA 12.8); the
#: budget wherever no card is present
DEVICE_HBM_BYTES = 85_017_493_504
#: the caching allocator rounds every block up to this many bytes
ALLOC_BLOCK = 512
#: cuBLAS's workspaces for each (handle, stream) pair, taken from the caching
#: allocator, at most: 32 MiB at the pair's first product and 1 MiB more
#: (cuBLASLt's) at its first bias GEMM (``addmm``), as
#: ``tools/audits_probe.py`` reads them on the card above.  Each thread has
#: a handle of its own, the autograd engine's device thread too.  A CUDA
#: graph's capture clears the pairs' workspaces and takes new ones inside
#: its private pool, which it holds for its life.
LIBRARY_WORKSPACE_BYTES = 33 * 2**20


def device_hbm_bytes() -> int:
    """The card's memory: read from the card when one is present."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return DEVICE_HBM_BYTES


def alloc_bytes(nbytes: int) -> int:
    """Bytes the caching allocator charges for a block of ``nbytes``."""
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


# ---------------------------------------------------------------------------
# fake tensors
# ---------------------------------------------------------------------------

def trace_device(device=None) -> torch.device:
    """The device of a fake trace.  ``None`` means the card: ``cuda``
    wherever torch is built with CUDA (no card needed: fake tensors touch
    none).  A torch built for the CPU alone cannot index fake CUDA tensors
    (its indexing asks for a CUDA device guard), so there ``None`` traces
    fake CPU tensors; operator counts and bytes do not depend on it."""
    if device is None:
        return torch.device("cuda" if torch.backends.cuda.is_built()
                            else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("this torch is built without CUDA: a fake CUDA "
                           "trace needs a CUDA build; pass device='cpu'")
    return dev


def fake_mode():
    """A ``FakeTensorMode`` for the port's traces (real tensors made before
    it are allowed as inputs: they become constants of the trace)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------------
# FLOP formulas
# ---------------------------------------------------------------------------

def _mv_flops(a, b, *args, out_val=None, **kw) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _addmv_flops(c, a, b, *args, out_val=None, **kw) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _dot_flops(a, b, *args, out_val=None, **kw) -> int:
    return 2 * a.numel()


_EXTRA_FLOPS = {
    torch.ops.aten.mv: _mv_flops,
    torch.ops.aten.addmv: _addmv_flops,
    torch.ops.aten.dot: _dot_flops,
    torch.ops.aten.vdot: _dot_flops,
}

#: GEMM-family operators: their output width is checked against their
#: operands' (``trace_lint``'s accum-downcast) and their p-column calls are
#: counted (full-gemm-count)
GEMMS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
                   "vdot", "matmul", "einsum", "linear", "_scaled_mm"})


#: operators that make a block without writing it
_EMPTY = ("empty", "new_empty")


def _registry():
    global _FLOP_REGISTRY
    if _FLOP_REGISTRY is None:
        from torch.utils.flop_counter import flop_registry
        _FLOP_REGISTRY = flop_registry
    return _FLOP_REGISTRY


_FLOP_REGISTRY = None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

#: c10d operator -> the reference's collective kind
C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "reduce_": "reduce",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
    "gather_": "gather", "scatter_": "scatter",
}

#: the port's tallies (``distributed.sharding.collective_counts``) by kind
TALLY_OF_KIND = {"all-reduce": "all_reduce", "all-gather": "all_gather",
                 "reduce-scatter": "reduce_scatter"}


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes each rank puts on the wire for one collective of ``kind``
    over ``n`` ranks whose result on the rank is ``result_bytes`` (the
    reference's ring model)."""
    n = max(int(n), 2)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    return float(result_bytes)


def _group_size(args) -> int:
    """Ranks of the process group a ``c10d`` operator names (2 if none)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in a._type().qualified_name():
            return int(dist.ProcessGroup.unbox(a).size())
    return 2


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _tensors(x) -> list:
    flat, _ = tree_flatten(x)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Block:
    """One storage charged to a counter; its finalizer returns the bytes
    when the last tensor that holds it is collected."""
    __slots__ = ("__weakref__",)


#: the namespace of the port's kernels as operators (``kernels.ops``)
KERNEL_NAMESPACE = "repro_torch"

#: FLOPs of one kernel call, by operator name (the screens and the prox are
#: elementwise: their cost is their bytes)
KERNEL_FLOPS = {"xtv": lambda X, v: 2 * X.shape[0] * X.shape[1]}


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes moved, live-byte peak and collectives of the
    operators run under it (see the module docstring).

    ``in_loop`` (a context) marks what runs inside the loop body a caller
    names; ``events`` (when ``record=True``) keeps one record per operator:
    ``(name, input dtypes, output dtypes, input shapes, in_loop,
    devices)`` for ``analysis.trace_lint``.  ``memory=False`` skips the
    live-byte accounting (the lint needs none)."""

    def __init__(self, record: bool = False, memory: bool = True):
        super().__init__()
        self.memory = memory
        self.flops = 0.0
        self.registry_flops = 0.0     # FlopCounterMode's formulas alone
        self.flops_by_op: Counter = Counter()
        self.flops_by_dtype: Counter = Counter()
        self.bytes_moved = 0.0
        self.live = 0
        self.peak = 0
        self.collectives: dict = {}
        self.kernel_calls: Counter = Counter()
        self.record = record
        self.events: list = []
        self._loop_depth = 0

    # -- the loop marker -----------------------------------------------------
    @contextlib.contextmanager
    def in_loop(self):
        self._loop_depth += 1
        try:
            yield
        finally:
            self._loop_depth -= 1

    # -- storage accounting --------------------------------------------------
    def _charge(self, t: torch.Tensor) -> None:
        nbytes = alloc_bytes(t.untyped_storage().nbytes())
        block = _Block()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(block, self._release, nbytes)
        t._cost_block = block         # the tensor keeps its storage charged

    def _release(self, nbytes: int) -> None:
        self.live -= nbytes

    @staticmethod
    def _share(out: torch.Tensor, args) -> None:
        """A view or in-place result keeps its base's storage charged."""
        base = getattr(out, "_cost_block", None)
        if base is not None:
            return
        for a in _tensors(args):
            blk = getattr(a, "_cost_block", None)
            if blk is not None and a.untyped_storage()._cdata == \
                    out.untyped_storage()._cdata:
                out._cost_block = blk
                return

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        ns = func.namespace
        name = packet.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        returns = func._schema.returns
        # a result is fresh unless the schema aliases it or it shares an
        # operand's storage (``unbind``'s list of views is annotated on its
        # elements)
        in_st = {t.untyped_storage()._cdata for t in ins}
        fresh, aliased = [], []
        flat_out = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(flat_out):
            alias = (i < len(returns)
                     and returns[i].alias_info is not None)
            for t in _tensors(o):
                view = alias or t.untyped_storage()._cdata in in_st
                (aliased if view else fresh).append(t)
        if ns == "c10d":
            self._collective(name, args, outs)
            return
        if ns == KERNEL_NAMESPACE:
            self._kernel(name, ins, outs,
                         KERNEL_FLOPS.get(name, lambda *a: 0)(*args))
            if self.memory:
                for t in fresh:
                    self._charge(t)
            return
        reg = _registry()
        fl = 0
        if packet in reg:
            fl = reg[packet](*args, **kwargs, out_val=out)
            self.registry_flops += fl
        elif packet in _EXTRA_FLOPS:
            fl = _EXTRA_FLOPS[packet](*args, **kwargs, out_val=out)
        if fl:
            self.flops += fl
            self.flops_by_op[name] += fl
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops_by_dtype[dt] += fl
        # bytes: what the operator reads and writes (a view moves nothing;
        # an in-place result is written as well as read; a new empty block
        # is written by no one)
        written = [t for i, o in enumerate(flat_out)
                   if i < len(returns) and returns[i].alias_info is not None
                   and returns[i].alias_info.is_write for t in _tensors(o)]
        if (fresh or written or fl) and not name.startswith(_EMPTY):
            self.bytes_moved += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in fresh) + \
                sum(_nbytes(t) for t in written)
        if self.memory:
            for t in fresh:
                self._charge(t)
            for t in aliased:
                self._share(t, args)
        self._record(f"{ns}.{name}", "aten", ins, outs)

    def _record(self, op, kind, ins, outs) -> None:
        if self.record:
            self.events.append(dict(
                op=op, kind=kind, in_dtypes=[t.dtype for t in ins],
                out_dtypes=[t.dtype for t in outs],
                in_shapes=[tuple(t.shape) for t in ins],
                in_devices={t.device.type for t in ins},
                out_devices={t.device.type for t in outs},
                in_loop=self._loop_depth > 0))

    def _collective(self, name, args, outs) -> None:
        kind = C10D_KINDS.get(name, name)
        n = _group_size(args)
        # the result on this rank: the output tensors (the in-place ones
        # for all_reduce / broadcast)
        b = sum(_nbytes(t) for t in outs)
        ent = self.collectives.setdefault(
            kind, {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        ent["count"] += 1
        ent["payload_bytes"] += b
        ent["wire_bytes"] += wire_bytes(kind, b, n)
        self.bytes_moved += 2.0 * b
        self._record(f"c10d.{name}", "collective", [], [])

    def _kernel(self, name, ins, outs, flops) -> None:
        self.kernel_calls[name] += 1
        self.bytes_moved += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        if flops:
            self.flops += flops
            self.flops_by_op[f"kernel.{name}"] += flops
            self.flops_by_dtype["float32"] += flops
        self._record(f"kernel.{name}", "kernel", ins, outs)

    @property
    def wire_bytes(self) -> float:
        return sum(e["wire_bytes"] for e in self.collectives.values())

    def collective_counts(self) -> dict:
        return {k: e["count"] for k, e in self.collectives.items()}


@dataclasses.dataclass
class Cost:
    """A counted step: FLOPs by operand dtype, bytes moved, collectives."""
    flops_by_dtype: dict
    bytes_moved: float
    wire_bytes: float
    collectives: dict

    @classmethod
    def of(cls, counter: CostCounter) -> "Cost":
        return cls(dict(counter.flops_by_dtype), counter.bytes_moved,
                   counter.wire_bytes,
                   {k: dict(v) for k, v in counter.collectives.items()})

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))


def _peak_rate(dtype: str, tf32: bool) -> float:
    if dtype in ("bfloat16", "float16"):
        return BF16_FLOPS
    if dtype == "float32" and tf32:
        return TF32_FLOPS
    # float32 outside the tensor cores; float64 is held to the same rate
    return F32_FLOPS


def roofline_terms(cost: Cost, *, tf32: bool = False) -> dict:
    """Seconds at the H100 SXM's peaks (``DEVICE_NAME`` at its 700 W
    limit): compute (each dtype's FLOPs at its rate; float32 at the
    non-tensor-core rate unless ``tf32``), memory (bytes at 3.35 TB/s) and
    collectives (wire bytes at NVLink's 450 GB/s each way).  Which one
    dominates, and the compute share of the bound."""
    t_compute = sum(f / _peak_rate(dt, tf32)
                    for dt, f in cost.flops_by_dtype.items())
    t_memory = cost.bytes_moved / HBM_BYTES_PER_S
    t_coll = cost.wire_bytes / LINK_BYTES_PER_S
    terms = {"device": DEVICE_NAME, "flops": cost.flops,
             "flops_by_dtype": dict(cost.flops_by_dtype),
             "bytes": cost.bytes_moved, "wire_bytes": cost.wire_bytes,
             "coll_counts": {k: v["count"]
                             for k, v in cost.collectives.items()},
             "t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_coll}
    terms["dominant"] = max(("t_compute", "t_memory", "t_collective"),
                            key=lambda k: terms[k])
    bound = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms


__all__ = ["ALLOC_BLOCK", "BF16_FLOPS", "C10D_KINDS",
           "Cost", "CostCounter", "DEVICE_HBM_BYTES", "DEVICE_NAME",
           "F32_FLOPS", "GEMMS", "HBM_BYTES_PER_S", "KERNEL_FLOPS",
           "KERNEL_NAMESPACE", "LIBRARY_WORKSPACE_BYTES", "LINK_BYTES_PER_S",
           "TF32_FLOPS", "alloc_bytes", "device_hbm_bytes",
           "fake_mode", "is_fake", "roofline_terms",
           "trace_device", "wire_bytes"]

