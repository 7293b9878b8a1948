"""Logical-plan IR: what a query MEANS, decoupled from how it executes.

The seed front-end was the physical operator tree itself — users hand-built
``Scan/Filter/Join/Sort/Aggregate`` dataclasses, so the shape the engine
executed was exactly the shape the user typed, and *representation timing*
(the paper's core concern) was fixed at plan-assembly time.  The logical
layer breaks that coupling:

  * logical nodes (``LScan``, ``LFilter``, ``LProject``, ``LJoin``,
    ``LSort``, ``LAggregate``, ``LGroupBy``) describe intent; the rewrite
    planner (:mod:`repro_torch.core.planner`) decides operator placement, column
    movement, and fragment boundaries *late*, against the actual relations;
  * filter predicates are preferably :class:`repro_torch.core.expr.Expr` trees —
    introspectable (pushdown, pruning, canonical cache tokens) — but opaque
    callables remain accepted so every legacy plan still lowers;
  * :func:`from_physical` is the lowering shim: any seed-style physical
    dataclass tree converts to the IR, executes through the planner, and
    produces identical results (the executor also keeps its direct walk, so
    legacy call sites are untouched either way).

Schemas follow the engine's join naming contract: a join serves the probe
side's columns under their own names and the build side's non-key columns
prefixed ``b_``; name collisions resolve the same way the physical engine's
dict-merge does (the build column wins).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple, Union

from .relation import Relation

__all__ = ["LScan", "LFilter", "LProject", "LJoin", "LSort", "LAggregate",
           "LGroupBy", "LogicalNode", "schema", "is_scalar", "from_physical"]


@dataclasses.dataclass
class LScan:
    """Leaf: a named base relation."""

    relation: Relation
    name: str = "scan"


@dataclasses.dataclass
class LFilter:
    """Row selection.  ``predicate`` is an :class:`~repro_torch.core.expr.Expr`
    (introspectable — the planner can push it down and prune around it) or
    any legacy callable ``view -> bool mask`` (kept in place, opaque)."""

    child: "LogicalNode"
    predicate: Union[Callable, object]


@dataclasses.dataclass
class LProject:
    """Column subset (declared projection; the planner also derives implicit
    projections from column usage)."""

    child: "LogicalNode"
    columns: Tuple[str, ...]


@dataclasses.dataclass
class LJoin:
    """Equi-join on one or more same-named key columns.

    Multi-key joins are a logical-only concept: the planner lowers them to a
    single-key physical join via key packing (see
    :func:`repro_torch.core.planner.pack_pair`).
    """

    build: "LogicalNode"
    probe: "LogicalNode"
    on: Tuple[str, ...]


@dataclasses.dataclass
class LSort:
    child: "LogicalNode"
    keys: Tuple[str, ...]


@dataclasses.dataclass
class LAggregate:
    """Scalar reduction root (sum | count | min | max)."""

    child: "LogicalNode"
    column: str
    fn: str = "sum"


@dataclasses.dataclass
class LGroupBy:
    child: "LogicalNode"
    key: str
    values: Dict[str, str]  # column -> agg fn


LogicalNode = Union[LScan, LFilter, LProject, LJoin, LSort, LAggregate,
                    LGroupBy]


def join_schema(build_s: Sequence[str], probe_s: Sequence[str],
                on: Sequence[str]) -> Tuple[str, ...]:
    """Output schema of a join: probe columns, then ``b_``-prefixed build
    columns (key columns served once, from the probe side).  Mirrors the
    physical engine's dict merge, including its collision rule."""
    out = list(probe_s)
    for n in build_s:
        if n in on:
            continue
        bn = f"b_{n}"
        if bn not in out:
            out.append(bn)
    return tuple(out)


def schema(node: LogicalNode) -> Tuple[str, ...]:
    """Output column names of a logical node (``()`` for a scalar root)."""
    if isinstance(node, LScan):
        return node.relation.names
    if isinstance(node, (LFilter, LSort)):
        return schema(node.child)
    if isinstance(node, LProject):
        return tuple(node.columns)
    if isinstance(node, LJoin):
        return join_schema(schema(node.build), schema(node.probe), node.on)
    if isinstance(node, LAggregate):
        return ()
    if isinstance(node, LGroupBy):
        return (node.key,) + tuple(f"{fn}_{c}" for c, fn in node.values.items())
    raise TypeError(f"not a logical node: {node!r}")


def is_scalar(node: LogicalNode) -> bool:
    return isinstance(node, LAggregate)


def from_physical(plan) -> LogicalNode:
    """Lowering shim: seed-style physical dataclass trees → logical IR.

    Opaque predicates survive as-is (the planner keeps them in place); every
    structural node maps one-to-one, so a lowered-then-planned legacy tree
    executes the same operators over the same inputs.
    """
    from .executor import (Aggregate, Filter, GroupBy, Join, Project, Scan,
                           Sort)

    if isinstance(plan, Scan):
        return LScan(plan.relation, plan.name)
    if isinstance(plan, Filter):
        return LFilter(from_physical(plan.child), plan.predicate)
    if isinstance(plan, Project):
        return LProject(from_physical(plan.child), tuple(plan.columns))
    if isinstance(plan, Join):
        return LJoin(from_physical(plan.build), from_physical(plan.probe),
                     (plan.key,))
    if isinstance(plan, Sort):
        return LSort(from_physical(plan.child), tuple(plan.keys))
    if isinstance(plan, Aggregate):
        return LAggregate(from_physical(plan.child), plan.column, plan.fn)
    if isinstance(plan, GroupBy):
        return LGroupBy(from_physical(plan.child), plan.key,
                        dict(plan.values))
    raise TypeError(f"cannot lower {type(plan).__name__} to the logical IR")
