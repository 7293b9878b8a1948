"""Logical partition lanes for sharded fused fragments.

The reference runs a sharded fragment under ``shard_map`` over a 1-D mesh
of ``num_parts`` devices (axis ``"part"``), one hash partition per device;
its tests and figures force eight host-platform devices on one CPU.  The
port runs the same contract on one card: the ``num_parts`` co-partitions
are the rows of ``(num_parts, bucket)`` tensors and one batched sequence of
device ops serves them all, while the broker's gang lease holds one logical
lane per partition.  No mesh object exists, so the lane count is a
constant, the reference's forced mesh width, and not the number of cards.
"""
from __future__ import annotations

__all__ = ["PART_AXIS", "LOGICAL_LANES", "available_partitions",
           "check_partitions"]

#: the name of the partition axis (dim 0 of every partitioned column)
PART_AXIS = "part"

#: logical lanes a sharded fragment can fan out over on one card
LOGICAL_LANES = 8


def available_partitions() -> int:
    """Lanes a sharded fragment can fan out over: :data:`LOGICAL_LANES`."""
    return LOGICAL_LANES


def check_partitions(num_parts: int) -> int:
    """``num_parts`` as an int, or ``ValueError`` outside ``1 ..
    available_partitions()`` (the reference's ``relational_mesh`` check)."""
    num_parts = int(num_parts)
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    if num_parts > available_partitions():
        raise ValueError(
            f"num_parts={num_parts} exceeds the {available_partitions()} "
            f"logical partition lanes")
    return num_parts
