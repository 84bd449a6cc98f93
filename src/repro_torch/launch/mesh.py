"""Process groups of the port's multi-device routes (the counterpart of
``repro.launch.mesh``).  Only the feature group is ported; the fold mesh
(``make_fold_mesh``, ``make_fold_feature_mesh``, ``fold_shard_compatible``,
``shard_over_folds``) waits for ROADMAP queue 1, item 25."""
from __future__ import annotations


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
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() != int(n_shards):
        return None
    return dist.group.WORLD
