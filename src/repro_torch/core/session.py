"""Fluent Session/Query front-end: the primary query API.

A :class:`Session` owns everything with cross-query lifetime — the
:class:`~repro_torch.core.executor.Executor`, the
:class:`~repro_torch.core.path_selector.PathSelector` and its
:class:`~repro_torch.core.runtime_profile.RuntimeProfile` feedback loop, and the
registered base tables (whose device column caches and key sketches live on
the ``Relation`` instances the session keeps alive).  A :class:`Query` is an
immutable builder over the logical IR:

    >>> import numpy as np
    >>> from repro_torch.core import Relation, Session, col
    >>> sess = Session(work_mem=1 << 20, device="cpu")
    >>> sess.register("orders", Relation.from_dict(
    ...     {"uid": [1, 2, 1], "w": [10, -5, 7]}))
    >>> sess.register("users", Relation.from_dict(
    ...     {"uid": [1, 2], "region": [0, 1]}))
    >>> q = (sess.table("orders")
    ...      .join(sess.table("users"), on="uid")
    ...      .filter(col("w") > 0)
    ...      .group_by("uid", {"w": "sum"}))
    >>> q.collect().relation["sum_w"].tolist()
    [17.0]

Each ``collect()`` runs the rewrite planner (filter pushdown, projection
pruning, multi-key packing, fragment chaining) and executes the resulting
stage chain through the session's executor: every fragment is priced by
``choose_fragment`` against the *rewritten* plan, observations feed the
shared runtime profile, and repeated queries hit the session-lifetime device
caches.

Join naming contract (same as the physical engine): ``a.join(b, on=...)``
keeps ``a``'s column names and serves ``b``'s non-key columns as
``b_<name>``; ``a`` is the probe side, ``b`` the build side.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from ..device import resolve_device
from .executor import Executor, QueryResult
from .expr import Expr
from .logical import (LAggregate, LFilter, LGroupBy, LJoin, LProject, LScan,
                      LSort, LogicalNode, schema)
from .memory_governor import MemoryGovernor
from .metrics import span
from .path_selector import PathSelector
from .resource_broker import ResourceBroker
from .relation import Relation
from .runtime_profile import RuntimeProfile

__all__ = ["Session", "Query"]

MB = 1 << 20


class Session:
    """Query-stream scope: executor + selector + feedback + table registry.

    A Session is safe to share across worker threads (the serving
    configuration, :class:`~repro_torch.core.server.QueryServer`): the
    program cache, device column cache, and runtime profile it reaches are
    all lock-guarded, and passing a :class:`~repro_torch.core.memory_governor.
    MemoryGovernor` makes every linear operator draw its work_mem from the
    shared budget instead of the private ``work_mem`` ceiling.  Resource
    acquisition is mediated by a :class:`~repro_torch.core.resource_broker.
    ResourceBroker` (``self.broker``): memory leases, device dispatch
    leases, and the pressure quotes that make ``auto`` queue-aware; pass an
    explicit ``broker`` to control queue pricing or share a device queue.

    Tensor-path work runs on ``device``: the CUDA card unless the caller
    asks for the CPU (``device="cpu"``).  Without a card and without
    ``device="cpu"`` the constructor raises.  A sharded fragment
    (``max_shards > 1``) places its partitions on every visible card for
    ``device="cuda"``, on the one device otherwise, or on the devices of a
    tuple (its first is ``device`` for everything else).
    """

    def __init__(self, work_mem: int = 64 * MB, policy: str = "auto",
                 selector: Optional[PathSelector] = None,
                 profile: Optional[RuntimeProfile] = None,
                 fuse: bool = True, spill_root: Optional[str] = None,
                 governor: Optional["MemoryGovernor"] = None,
                 broker: Optional["ResourceBroker"] = None,
                 faults=None, retry=None, max_shards: int = 1,
                 tiers=None, guards: bool = True, device="cuda"):
        resolve_device(device)  # no card and no device="cpu": raise now
        if broker is not None and governor is not None \
                and broker.governor is not governor:
            raise ValueError(
                "pass either governor or broker (or a broker built over "
                "that governor); conflicting governors would split the "
                "budget accounting")
        if broker is not None and governor is None:
            governor = broker.governor
        if selector is None:
            force = None if policy == "auto" else policy
            selector = PathSelector(work_mem, force=force,
                                    profile=profile or RuntimeProfile(),
                                    tiers=None if tiers is True else tiers)
        elif profile is not None and profile is not selector.profile:
            raise ValueError(
                "pass either selector or profile: an explicit selector "
                "already owns its feedback profile")
        elif policy != "auto" and selector.force != policy:
            # Executor would overwrite selector.force in place, silently
            # re-pinning every other Session sharing this selector
            raise ValueError(
                f"policy={policy!r} conflicts with the explicit selector "
                f"(force={selector.force!r}); a shared selector's policy "
                f"belongs to the selector")
        self.selector = selector
        self.profile = selector.profile
        self.governor = governor
        # ``guards`` toggles mid-query adaptive re-planning (execution-time
        # guards on costed linear operators); off is the static-decision
        # ablation the fig14 robustness map measures against
        self.executor = Executor(work_mem, policy=policy, selector=selector,
                                 spill_root=spill_root, fuse=fuse,
                                 governor=governor, broker=broker,
                                 faults=faults, retry=retry,
                                 max_shards=max_shards, tiers=tiers,
                                 guards=guards, device=device)
        self.device = self.executor.device
        # the executor normalizes tiers (True -> default TierConfig) and
        # back-fills selector.tiers; expose the resolved config + ledger
        self.tiers = self.executor.tiers
        self.tier_ledger = self.executor.tier_ledger
        # the executor resolves the broker (private one per governor, the
        # process default otherwise); the session exposes it as the single
        # handle for leases, quotes and queue stats
        self.broker = self.executor.broker
        self._tables: Dict[str, Relation] = {}

    # -- table registry ----------------------------------------------------
    def register(self, name: str, relation) -> "Session":
        """Register a base table (a Relation or a dict of columns).  The
        session keeps the instance alive, so its device column cache and key
        sketches persist across queries."""
        if not isinstance(relation, Relation):
            relation = Relation.from_dict(relation)
        self._tables[name] = relation
        return self

    def table(self, name: str) -> "Query":
        if name not in self._tables:
            raise KeyError(f"unknown table {name!r}; registered: "
                           f"{sorted(self._tables)}")
        return Query(self, LScan(self._tables[name], name))

    def from_relation(self, relation: Relation, name: str = "t") -> "Query":
        """Ad-hoc query over an unregistered relation."""
        return Query(self, LScan(relation, name))

    # -- execution ---------------------------------------------------------
    def execute(self, plan, rewrite: bool = True) -> QueryResult:
        """Run a Query, a logical tree, or a legacy physical dataclass tree
        (lowered through :func:`repro_torch.core.logical.from_physical`)."""
        from .planner import plan_program

        with span("query"):
            with span("plan"):
                node = plan.logical() if isinstance(plan, Query) else plan
                program = plan_program(node, rewrite=rewrite)
            return program.run(self.executor)


class Query:
    """Immutable fluent builder over the logical IR.  Every method returns a
    new Query; nothing executes until :meth:`collect`."""

    def __init__(self, session: Session, node: LogicalNode):
        self._session = session
        self._node = node

    def logical(self) -> LogicalNode:
        return self._node

    def schema(self) -> tuple:
        """Output column names this query will produce (``()`` for a scalar
        aggregate root)."""
        return schema(self._node)

    def _derive(self, node: LogicalNode) -> "Query":
        return Query(self._session, node)

    # -- operators ---------------------------------------------------------
    def filter(self, predicate) -> "Query":
        """Keep rows where ``predicate`` holds.  Prefer an
        :class:`~repro_torch.core.expr.Expr` (``col("w") > 0``): the planner can
        push it below joins, prune around it, and cache compiled programs by
        its canonical token.  A plain callable still works but stays opaque.
        """
        if isinstance(predicate, Expr):
            missing = predicate.columns() - set(schema(self._node))
            if missing:
                raise KeyError(f"filter references unknown column(s) "
                               f"{sorted(missing)}; have {self.schema()}")
        return self._derive(LFilter(self._node, predicate))

    def select(self, *columns: str) -> "Query":
        missing = set(columns) - set(schema(self._node))
        if missing:
            raise KeyError(f"select references unknown column(s) "
                           f"{sorted(missing)}; have {self.schema()}")
        return self._derive(LProject(self._node, tuple(columns)))

    def join(self, other: Union["Query", str, Relation],
             on: Union[str, Sequence[str]]) -> "Query":
        """Equi-join: ``self`` is the probe side (keeps its column names),
        ``other`` the build side (non-key columns served as ``b_<name>``).
        ``on`` names one or more key columns present on both sides; multiple
        keys lower to a packed single-key physical join."""
        if isinstance(other, str):
            other = self._session.table(other)
        elif isinstance(other, Relation):
            other = self._session.from_relation(other)
        keys = (on,) if isinstance(on, str) else tuple(on)
        if not keys:
            raise ValueError("join needs at least one key column")
        for side, q in (("probe", self), ("build", other)):
            missing = set(keys) - set(schema(q._node))
            if missing:
                raise KeyError(f"join key(s) {sorted(missing)} missing from "
                               f"the {side} side {schema(q._node)}")
        return self._derive(LJoin(other._node, self._node, keys))

    def sort(self, *keys: str) -> "Query":
        missing = set(keys) - set(schema(self._node))
        if missing:
            raise KeyError(f"sort references unknown column(s) "
                           f"{sorted(missing)}; have {self.schema()}")
        return self._derive(LSort(self._node, tuple(keys)))

    def group_by(self, key: str, values: Dict[str, str]) -> "Query":
        cols = {key} | set(values)
        missing = cols - set(schema(self._node))
        if missing:
            raise KeyError(f"group_by references unknown column(s) "
                           f"{sorted(missing)}; have {self.schema()}")
        return self._derive(LGroupBy(self._node, key, dict(values)))

    def aggregate(self, column: str, fn: str = "sum") -> "Query":
        """Scalar reduction root: sum | count | min | max."""
        if column not in schema(self._node):
            raise KeyError(f"aggregate column {column!r} not in "
                           f"{self.schema()}")
        return self._derive(LAggregate(self._node, column, fn))

    # -- execution ---------------------------------------------------------
    def collect(self, rewrite: bool = True) -> QueryResult:
        """Plan (rewrite → chain fragments) and execute; returns the full
        :class:`~repro_torch.core.executor.QueryResult` with per-operator metrics
        and path decisions."""
        return self._session.execute(self, rewrite=rewrite)

    def to_relation(self) -> Relation:
        res = self.collect()
        if res.relation is None:
            raise ValueError("scalar query; use .scalar()")
        return res.relation

    def scalar(self) -> float:
        res = self.collect()
        if res.scalar is None:
            raise ValueError("relation query; use .to_relation()")
        return res.scalar

    def explain(self, rewrite: bool = True) -> str:
        """The planned stage chain, post-rewrite (pushdown, pruning, packing
        and fragment boundaries are all visible here).

        One line per physical fragment, in run order::

            stage 0: join[uid](rel[100x2], rel[1000x3]) → filter((col('w') > 0))
            stage 1: join[pid](rel[50x1], #0) → sort['uid'] → agg[sum(w)]

        Notation: ``join[keys](build, probe)`` is the fragment's equi-join
        core (``(packed)`` marks a multi-key join lowered through one packed
        int64 coordinate); ``rel[NxC]`` a base-table scan of N rows × C
        columns *after projection pruning*; ``#j`` the output of stage
        ``j`` (fragment chaining); ``scan(...)`` a single-table stage.  The
        arrow chain lists the fused-fragment stages in execution order —
        ``filter(<expr>)`` (a pushed-down typed expression; opaque callables
        print ``filter(<fn>)``), ``sort[keys]``, ``project[cols]``,
        ``group_by[k]{col: fn}``, ``agg[fn(col)]``.  Each stage line is one
        ``Join→[Filter]→[Sort]→[Aggregate]`` unit priced and executed as a
        whole, so ``QueryResult.decisions`` carries (at least) one entry per
        stage — the key for interpreting fig11 runs and benchmark CSVs.
        See ``docs/query-api.md`` for the full table.
        """
        from .planner import plan_program

        return plan_program(self._node, rewrite=rewrite).explain()

    def __repr__(self) -> str:
        cols = ", ".join(self.schema()) or "<scalar>"
        return f"Query[{cols}]"
