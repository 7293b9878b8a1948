"""The port's ``distributed``: partition lanes of the sharded relational
fragment, and the LM's sharding rules and DTensor layouts
(:mod:`.sharding`)."""
from .sharding import (LOGICAL_LANES, PART_AXIS, NamedSharding,
                       PartitionSpec, available_partitions, batch_specs,
                       cache_specs, check_partitions, distribute_tree,
                       dp_axes, param_specs, tree_shardings)

__all__ = ["PART_AXIS", "LOGICAL_LANES", "available_partitions",
           "check_partitions", "PartitionSpec", "NamedSharding", "dp_axes",
           "param_specs", "batch_specs", "cache_specs", "tree_shardings",
           "distribute_tree"]
