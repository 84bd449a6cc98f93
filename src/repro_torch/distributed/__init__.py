"""Feature-parallel execution of the port: the group-aligned column
partition of the design and its executors (``feature_shard``), on one
device or across ``torch.distributed`` ranks."""
