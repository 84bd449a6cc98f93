"""Process groups of the port's multi-device routes (the counterpart of
``repro.launch.mesh``) on ``torch.distributed``.

* The feature group (``make_feature_mesh``): one column block a rank, for
  ``Plan(feature_shards=S)``.
* The fold mesh (``make_fold_mesh``, ``make_fold_feature_mesh``,
  ``fold_axis_size``, ``fold_shard_compatible``, ``shard_over_folds``):
  K-fold model selection with each fold cohort split across ranks.  A
  ``FoldMesh`` plays the part of the reference's ``jax.sharding.Mesh``:
  ``axis_names``, ``shape`` and ``size`` read as a mesh's do, and this
  rank's process groups ride along.

Where the reference's single controller leaves devices out of a mesh,
SPMD ranks cannot sit idle unnoticed: a world larger than the mesh is
refused with ``ValueError`` (see ``make_fold_mesh``).

Every process group is built by every rank in the same order (a
``new_group`` call is collective).  The fold group gathers host copies of
the sweep outputs, so it is a ``gloo`` group whatever the default
backend; the feature group uses the default backend, with a ``gloo`` twin
for its host gathers when that backend is not ``gloo``.

* The LM mesh (``make_local_mesh``, ``make_production_mesh``,
  ``lm_mesh``): the LM zoo's (data, model) or (pod, data, model) ranks.
  An ``LMMesh`` reads as the reference's ``jax.sharding.Mesh`` does and
  carries one ``gloo`` group for each combination of its axes, which
  ``distributed.sharding`` gathers and reduces over.

* Fake worlds (``fake_world``, ``abstract_fold_mesh``,
  ``abstract_feature_mesh``): rank 0's view of a ``torch.distributed``
  process group of n ranks on the ``fake`` backend, which runs every
  collective without moving a byte.  They are for tracing only (the
  resource audit's collective plans, the dry run's 256- and 512-rank
  meshes, on fake tensors); a fake world initializes the default group,
  so it runs in a process of its own.
"""
from __future__ import annotations

import itertools

import numpy as np

FOLD_TALLIES = ("sharded", "unsharded", "all_gather")
_COUNTS = dict.fromkeys(FOLD_TALLIES, 0)


def fold_counts() -> dict:
    """What the fold mesh did in this process since the last reset:
    cohort launches split across the fold axis (``sharded``), each with
    one ``all_gather``, and launches whose cohort the fold axis does not
    divide (``unsharded``: every rank runs the whole cohort)."""
    return dict(_COUNTS)


def reset_fold_counts() -> None:
    for name in FOLD_TALLIES:
        _COUNTS[name] = 0


def _world() -> tuple:
    """(world size, this rank) of the default group; (1, 0) when
    ``torch.distributed`` is not initialized."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _gloo_group(ranks):
    """A ``gloo`` group of ``ranks``: the default group itself when it is
    that group, else a new one (every rank must make this call).  In a
    fake world every group is fake."""
    import torch.distributed as dist
    backend = dist.get_backend()
    if len(ranks) == dist.get_world_size() and backend in ("gloo", "fake"):
        return dist.group.WORLD
    return dist.new_group(list(ranks),
                          backend=None if backend == "fake" else "gloo")


class fake_world:
    """``with fake_world(n):`` rank 0 of a world of ``n`` ranks on the
    ``fake`` backend (every collective returns at once, moving nothing),
    destroyed on exit.  It initializes the default group: run it in a
    process of its own, never beside a real group."""

    def __init__(self, n: int, rank: int = 0):
        self.n, self.rank = int(n), int(rank)

    def __enter__(self):
        import torch.distributed as dist
        # importing it registers the ``fake`` backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=self.n)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False


def abstract_fold_mesh(n_shards: int) -> "FoldMesh":
    """Rank 0's view of a 1-D 'fold' mesh of ``n_shards`` ranks, for tracing
    only: inside ``fake_world(n_shards)``, ``make_fold_mesh`` over the fake
    group (``shard_over_folds`` then splits a cohort as it would across
    real ranks, and its collectives move nothing)."""
    world, _ = _world()
    if world != int(n_shards):
        raise ValueError(f"abstract_fold_mesh({n_shards}) needs a fake "
                         f"world of {n_shards} ranks, not {world}")
    return make_fold_mesh(int(n_shards))


def abstract_feature_mesh(n_shards: int):
    """Rank 0's view of the feature group of ``n_shards`` ranks, for tracing
    only (inside ``fake_world(n_shards)``): the group
    ``make_feature_mesh`` gives, one column block a rank."""
    world, _ = _world()
    if world != int(n_shards):
        raise ValueError(f"abstract_feature_mesh({n_shards}) needs a fake "
                         f"world of {n_shards} ranks, not {world}")
    return make_feature_mesh(int(n_shards))


class FoldMesh:
    """A fold mesh of ``torch.distributed`` ranks.

    ``axis_names`` is ``("fold",)`` or ``("fold", "feature")``, ``shape``
    maps each axis to its size and ``size`` is their product, as on a JAX
    mesh.  Rank ``(f, s)`` of a 2-D mesh is global rank ``f * S + s``.
    ``coords`` holds this rank's coordinates; ``fold_group`` the ranks
    that share its feature coordinate (a ``gloo`` group, or ``None`` on a
    mesh of one), ``feature_group`` / ``feature_host_group`` the ranks
    that share its fold coordinate.

    Meshes compare and hash by ``(axis_names, shape, ranks)``, so equal
    meshes from repeated ``make_fold_mesh`` calls are one compile key."""

    def __init__(self, axis_names, shape, ranks, coords, fold_group=None,
                 feature_group=None, feature_host_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.ranks = tuple(int(r) for r in ranks)
        self.coords = dict(coords)
        self.fold_group = fold_group
        self.feature_group = feature_group
        self.feature_host_group = feature_host_group

    def _key(self) -> tuple:
        return (self.axis_names, tuple(self.shape.items()), self.ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, FoldMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"FoldMesh({self.shape}, ranks={self.ranks})"

    def __deepcopy__(self, memo) -> "FoldMesh":
        return self          # a handle on process groups, never copied


class LMMesh:
    """A mesh of ``torch.distributed`` ranks for the LM zoo.

    ``axis_names`` is ``("data", "model")`` or ``("pod", "data",
    "model")``, ``shape`` maps each axis to its size and ``size`` is their
    product, as on a JAX mesh.  Ranks are laid out row-major: rank ``(p,
    d, m)`` is global rank ``(p * D + d) * M + m``.  ``coords`` holds this
    rank's coordinates.  ``group(axes)`` is the ``gloo`` group of the
    ranks that share this rank's coordinates on every other axis (``None``
    when it holds one rank), one for every combination of axes.

    ``batch_replicated`` marks a view of the mesh under which every rank
    holds the whole batch (a batch that the data axes do not divide, or a
    decode step): ``replicated_batch()`` returns it, with the same groups.
    Meshes compare and hash by ``(axis_names, shape, ranks,
    batch_replicated)``; a deep copy is the mesh itself."""

    def __init__(self, axis_names, shape, ranks, coords, groups,
                 batch_replicated=False):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.size = int(np.prod(list(self.shape.values())))
        self.ranks = tuple(int(r) for r in ranks)
        self.coords = dict(coords)
        self._groups = dict(groups)
        self.batch_replicated = bool(batch_replicated)

    def _axes(self, axes) -> tuple:
        """``axes`` (a name or names) present in the mesh, in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def group(self, axes):
        return self._groups.get(self._axes(axes))

    def block_index(self, axes, coords=None) -> int:
        """This rank's (or ``coords``') block along ``axes`` taken in the
        given order, the first major (a spec entry's split)."""
        coords = self.coords if coords is None else coords
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            if a in self.shape:
                idx = idx * self.shape[a] + coords[a]
        return idx

    def coords_of(self, rank: int) -> dict:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def group_blocks(self, axes) -> list:
        """The block index along ``axes`` of each member of ``group(axes)``,
        in the group's rank order (ascending global rank)."""
        mine = self.coords
        members = [r for r in range(self.size)
                   if all(c == mine[a] for a, c in self.coords_of(r).items()
                          if a not in self._axes(axes))]
        return [self.block_index(axes, self.coords_of(r)) for r in members]

    def replicated_batch(self) -> "LMMesh":
        return LMMesh(self.axis_names, self.shape, self.ranks, self.coords,
                      self._groups, batch_replicated=True)

    def _key(self) -> tuple:
        return (self.axis_names, tuple(self.shape.items()), self.ranks,
                self.batch_replicated)

    def __eq__(self, other) -> bool:
        return isinstance(other, LMMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"LMMesh({self.shape}, coords={self.coords}"
                + (", batch replicated" if self.batch_replicated else "")
                + ")")

    def __deepcopy__(self, memo) -> "LMMesh":
        return self          # a handle on process groups, never copied


def lm_mesh(shape: dict) -> LMMesh:
    """An ``LMMesh`` of ``shape`` (axis name -> size, in mesh order) over
    the initialized default group, whose world size must equal the
    product; with no group initialized, a shape of one rank gives a mesh
    of one (no group, no collective).  Every rank must make this call, in
    the same order as its other ``new_group`` calls."""
    import torch.distributed as dist
    axis_names = tuple(shape)
    size = int(np.prod([int(shape[a]) for a in axis_names]))
    world, rank = _world()
    if size != world:
        raise ValueError(f"an LM mesh of shape {dict(shape)} needs {size} "
                         f"ranks, the world has {world}")
    mesh = LMMesh(axis_names, shape, range(size), {}, {})
    mesh.coords = mesh.coords_of(rank)
    groups, made = {}, {}
    for n in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, n):
            if mesh.axes_size(axes) == 1:
                continue
            # one group per class of the other axes' coordinates; every
            # rank makes every group, in the same order
            others = [a for a in axis_names if a not in axes]
            for key in itertools.product(*(range(mesh.shape[a])
                                           for a in others)):
                ranks = tuple(r for r in range(size) if all(
                    mesh.coords_of(r)[a] == c for a, c in zip(others, key)))
                if ranks not in made:
                    made[ranks] = _gloo_group(ranks)
                if rank in ranks:
                    groups[axes] = made[ranks]
    mesh._groups = groups
    return mesh


def make_local_mesh() -> LMMesh:
    """Every rank of the initialized default group as a ``(world, 1)``
    mesh over ``("data", "model")``; a mesh of one when no group is
    initialized (every code path is then the one without a mesh)."""
    return lm_mesh({"data": _world()[0], "model": 1})


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """Single pod: (data 16, model 16) = 256 ranks.  Multi-pod: (pod 2,
    data 16, model 16) = 512 ranks, 'pod' the data-parallel axis that
    crosses hosts.  A world of another size raises ``ValueError``."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return lm_mesh(shape)


def make_fold_mesh(n_folds: int) -> FoldMesh:
    """1-D 'fold' mesh for K-fold model selection.

    Its size ``d`` is the largest divisor of ``n_folds`` that is at most
    the world size of the initialized default group, so every rank
    carries the same number of folds; with no group initialized it is a
    mesh of one, and the fold sweep runs unsplit (as on a one-device JAX
    host).  A world larger than ``d`` raises ``ValueError``: SPMD ranks
    cannot be left out of the mesh as the reference's single controller
    leaves devices out, so run ``d`` ranks (a divisor of ``n_folds``)."""
    world, rank = _world()
    d = 1
    for c in range(min(int(n_folds), world), 0, -1):
        if n_folds % c == 0:
            d = c
            break
    if d < world:
        raise ValueError(
            f"make_fold_mesh({n_folds}): the largest divisor of {n_folds} "
            f"that fits {world} ranks is {d}, so {world - d} ranks would "
            f"hold no fold; run a world whose size divides n_folds")
    if d == 1:
        return FoldMesh(("fold",), {"fold": 1}, (rank,), {"fold": 0})
    return FoldMesh(("fold",), {"fold": d}, range(d), {"fold": rank},
                    fold_group=_gloo_group(range(d)))


def make_feature_mesh(n_shards: int):
    """The default ``torch.distributed`` process group when it is
    initialized with exactly ``n_shards`` ranks, one feature block a rank;
    else ``None``, and the caller runs the stacked executor (every block in
    one process: the same math and layout).

    The group must match the partition, which the group-aligned
    partitioner (``distributed.feature_shard``) has already fixed: a world
    of another size is not used, not even a divisor of it."""
    if n_shards <= 1:
        return None
    world, _ = _world()
    if world != int(n_shards):
        return None
    import torch.distributed as dist
    return dist.group.WORLD


def make_fold_feature_mesh(n_folds: int, n_shards: int):
    """2-D (fold, feature) mesh: the fold axis ``d`` is the largest divisor
    of ``n_folds`` above 1 that fits ``world // n_shards`` (as
    ``make_fold_mesh``), the feature axis takes exactly ``n_shards``.
    Returns ``None`` when the world cannot give a fold axis > 1; a world
    larger than ``d * n_shards`` raises ``ValueError`` (see
    ``make_fold_mesh``).

    The fold axis splits the fold sweeps; the feature axis replicates them
    and runs the sharded screens of ``Plan(feature_shards=n_shards)``
    over each fold coordinate's feature group."""
    if n_shards <= 1:
        return make_fold_mesh(n_folds)
    S = int(n_shards)
    world, rank = _world()
    d = 0
    for c in range(min(int(n_folds), world // S), 1, -1):
        if n_folds % c == 0:
            d = c
            break
    if d == 0:
        return None
    if d * S < world:
        raise ValueError(
            f"make_fold_feature_mesh({n_folds}, {n_shards}): a {d} x {S} "
            f"mesh leaves {world - d * S} of {world} ranks out; run "
            f"{d * S} ranks")
    import torch.distributed as dist
    f, s = divmod(rank, S)
    fold_group = feature_group = feature_host = None
    for s2 in range(S):              # every rank builds every group
        g = _gloo_group([f2 * S + s2 for f2 in range(d)])
        if s2 == s:
            fold_group = g
    gloo = dist.get_backend() in ("gloo", "fake")
    for f2 in range(d):
        ranks = [f2 * S + s2 for s2 in range(S)]
        g = dist.new_group(ranks)
        h = g if gloo else dist.new_group(ranks, backend="gloo")
        if f2 == f:
            feature_group, feature_host = g, h
    return FoldMesh(("fold", "feature"), {"fold": d, "feature": S},
                    range(d * S), {"fold": f, "feature": s},
                    fold_group=fold_group, feature_group=feature_group,
                    feature_host_group=feature_host)


def fold_axis_size(mesh) -> int:
    """Rank count along the 'fold' axis of ``mesh``.

    On a 1-D fold mesh this is ``mesh.size``; on a 2-D folds x features mesh
    only the 'fold' axis counts (the feature axis replicates the fold
    sweep, it never splits the fold rows).  Meshes without a 'fold' axis
    (including test doubles exposing only ``.size``) fall back to total
    size, as in the reference."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", None)
    if shape is not None:
        try:
            if "fold" in shape:
                return int(shape["fold"])
        except TypeError:
            pass
    return int(getattr(mesh, "size", 1))


def fold_shard_compatible(mesh, n_folds: int) -> bool:
    """True when a fold-batched launch of ``n_folds`` members should split
    them over ``mesh``: a 'fold' axis of more than one rank whose size
    divides the member count.  On a 2-D folds x features mesh only the
    fold-axis size matters.  The elastic fold scheduler re-checks this for
    every cohort launch: cohort sizes change as folds diverge in pace."""
    if mesh is None:
        return False
    d = fold_axis_size(mesh)
    return d > 1 and n_folds % d == 0


def _host(x):
    """A sweep output with its tensors copied to the host (the gather
    pickles them; the scheduler reads them there)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _gather_members(out: list, mesh) -> list:
    """Every rank's list of per-member outputs, concatenated in fold-group
    rank order: one ``all_gather`` on the fold group."""
    import torch.distributed as dist
    parts = [None] * fold_axis_size(mesh)
    dist.all_gather_object(parts, [_host(m) for m in out],
                           group=mesh.fold_group)
    _COUNTS["all_gather"] += 1
    return [m for part in parts for m in part]


def _fold_members(args, example_args) -> int:
    for a, ax in zip(args, example_args):
        if ax == 0:
            return len(a)
    raise ValueError("no argument carries the fold axis")


def shard_over_folds(fn, mesh, example_args):
    """Split a fold-batched function's members across the mesh's 'fold'
    axis.

    ``fn(*args)`` returns one output per member of the cohort;
    ``example_args`` marks which positional arguments carry the member
    axis (0: sliced, tensors and Python lists alike; ``None``:
    replicated).  Rank ``f`` of the fold group runs the contiguous block
    ``[f * Ka/d, (f + 1) * Ka/d)``, then one ``all_gather`` over the fold
    group gives every rank the whole cohort's outputs in member order, as
    the host reads the global array after the reference's ``shard_map``.
    Returns ``fn`` itself when the fold axis has one rank."""
    d = fold_axis_size(mesh)
    if mesh is None or d == 1:
        return fn

    def sharded(*args):
        blk = _fold_members(args, example_args) // d
        f = mesh.coords["fold"]
        local = [a[f * blk:(f + 1) * blk] if ax == 0 else a
                 for a, ax in zip(args, example_args)]
        _COUNTS["sharded"] += 1
        return _gather_members(fn(*local), mesh)
    return sharded


def run_unsharded(fn, mesh):
    """A fold-batched launch whose cohort the fold axis does not divide:
    every rank runs every member from its own identical inputs, as the
    reference's unsharded launch runs whole on one device, so no rank
    waits and no collective is needed (the screens are replicated the
    same way).  The launch is counted under ``unsharded``.  Returns
    ``fn`` itself when the fold axis has one rank."""
    if mesh is None or fold_axis_size(mesh) == 1:
        return fn

    def unsharded(*args):
        _COUNTS["unsharded"] += 1
        return fn(*args)
    return unsharded
