"""The port's ``distributed``: partition lanes of the sharded relational
fragment and their placement on the devices, and the LM's sharding rules
and DTensor layouts (:mod:`.sharding`)."""
from .sharding import (LOGICAL_LANES, PART_AXIS, NamedSharding,
                       PartitionPlacement, PartitionSpec,
                       available_partitions, batch_specs, cache_specs,
                       check_partitions, distribute_tree, dp_axes,
                       param_specs, partition_placement, placement_devices,
                       tree_shardings)

__all__ = ["PART_AXIS", "LOGICAL_LANES", "available_partitions",
           "check_partitions", "PartitionPlacement", "placement_devices",
           "partition_placement", "PartitionSpec", "NamedSharding",
           "dp_axes", "param_specs", "batch_specs", "cache_specs",
           "tree_shardings", "distribute_tree"]
