"""Sharding: the reference's logical-axis rules and their context, and the
placement of tensors on a single-controller mesh (``parallel/sharding.py``)."""
from repro_torch.parallel.sharding import (PartitionSpec, Sharded,
                                           ShardingRules, current_rules,
                                           default_rules, gather_tree,
                                           logical_shard, logical_spec,
                                           resolve_spec, shard_tree,
                                           use_sharding_rules)

__all__ = ["PartitionSpec", "Sharded", "ShardingRules", "current_rules",
           "default_rules", "gather_tree", "logical_shard", "logical_spec",
           "resolve_spec", "shard_tree", "use_sharding_rules"]
