"""Partition lanes of the port (the relational half of the reference's
``distributed/sharding``); the LM sharding rules are not ported yet."""
from .sharding import (PART_AXIS, LOGICAL_LANES, available_partitions,
                       check_partitions)

__all__ = ["PART_AXIS", "LOGICAL_LANES", "available_partitions",
           "check_partitions"]
