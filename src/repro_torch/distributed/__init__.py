"""Parallel execution of the port across ``torch.distributed`` ranks: the
group-aligned feature partition of the design and its executors
(``feature_shard``), the LM zoo's sharding rules and collectives
(``sharding``), and int8 gradient compression (``compression``)."""
