"""Rewrite-based planner: logical IR → chained physical fragments.

This is where *representation timing* becomes a planning decision instead of
an accident of how the user typed the query.  The pipeline:

  1. **Filter pushdown** (:func:`push_filters`) — ``Expr`` conjuncts move
     below every join whose output they don't need, landing directly above
     the lowest join that can serve their columns.  They deliberately stop
     *above* joins rather than sinking into scans: a filter above a
     ``Join(Scan, Scan)`` folds into the fused pipeline's validity mask for
     free, while a filtered scan would be a fresh (device-cache-cold)
     relation every query.  Opaque legacy callables stay where they were.
  2. **Projection pruning** (:func:`prune_columns`) — required columns flow
     root→leaves; scans shrink to the referenced subset via
     :meth:`Relation.select`, whose shared device-cache contract means the
     pruned scan re-uses (and warms) the parent's uploaded columns — H2D
     traffic pays only for columns the query actually reads.
  3. **Multi-key packing** (:func:`pack_pair`) — an ``LJoin`` on several key
     columns lowers to a single-key physical join over a packed ``int64``
     coordinate (range-compressed when the key ranges fit, per-column
     factorized otherwise); the packed column is content-token cached on the
     base relation so repeated queries re-use both the host array and its
     device upload.
  4. **Fragment extraction** (:func:`plan_program`) — each join becomes one
     physical stage shaped ``Join→[Filter]→[Sort]→[Aggregate]`` (the fused
     pipeline's contract), with filters sunk to sit directly above the join;
     a multi-join plan becomes a *chain* of such stages, each independently
     priced by ``PathSelector.choose_fragment`` against the rewritten (not
     the typed) plan and each eligible for fusion.

``plan_program`` accepts logical IR or (via the lowering shim) legacy
physical trees; ``rewrite=False`` skips the optimization rewrites (steps
1–2) for before/after measurement (see ``benchmarks/figures.py::fig10``) —
packing (3) and fragment extraction (4) are structural lowering a multi-key
or multi-join plan cannot execute without, so they always apply.
"""
from __future__ import annotations

import dataclasses
import operator
import threading
from functools import reduce
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .expr import CombinedPredicate, Expr
from .logical import (LAggregate, LFilter, LGroupBy, LJoin, LProject, LScan,
                      LSort, LogicalNode, from_physical, is_scalar,
                      join_schema, schema)
from .relation import Relation, column_token

__all__ = ["plan_program", "push_filters", "prune_columns", "pack_pair",
           "Program", "Stage", "PACK_COL"]

PACK_COL = "__pack__"

# Guards the per-relation packed-column caches: concurrent sessions plan
# multi-key joins over shared base tables, and the eviction sweeps below
# iterate the cache dict (unsafe against a concurrent insert).
_PACK_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# 1. Filter pushdown
# ---------------------------------------------------------------------------

def _has_join(node) -> bool:
    if isinstance(node, LJoin):
        return True
    child = getattr(node, "child", None)
    return child is not None and _has_join(child)


def _wrap_filters(node, preds):
    exprs = [p for p in preds if isinstance(p, Expr)]
    if exprs:
        node = LFilter(node, reduce(operator.and_, exprs))
    return node


def push_filters(node: LogicalNode, pending: Tuple = ()) -> LogicalNode:
    """Move ``Expr`` filter conjuncts below joins whose output they don't
    reference.  ``pending`` carries conjuncts still traveling downward; they
    re-attach directly above the lowest join (or scan, for single-table
    chains) that serves their columns."""
    pending = list(pending)
    if isinstance(node, LFilter):
        if isinstance(node.predicate, Expr):
            return push_filters(node.child,
                                pending + list(node.predicate.conjuncts()))
        # opaque callable: stays in place; Expr conjuncts commute past it
        return LFilter(push_filters(node.child, tuple(pending)),
                       node.predicate)
    if isinstance(node, (LSort, LProject)):
        # filters commute with (stable) sort and with projection: a filter
        # that sat above a projection only references surviving columns
        return dataclasses.replace(
            node, child=push_filters(node.child, tuple(pending)))
    if isinstance(node, (LGroupBy, LAggregate)):
        # aggregation boundaries: conjuncts from above reference aggregated
        # output names and must not cross
        new = dataclasses.replace(node, child=push_filters(node.child))
        return _wrap_filters(new, pending)
    if isinstance(node, LJoin):
        b_schema = set(schema(node.build))
        p_schema = set(schema(node.probe))
        keep, to_build, to_probe = [], [], []
        for c in pending:
            refs = c.columns()
            # the build side wins b_-named collisions (join naming contract):
            # any ref whose b_-stripped suffix exists on THIS build side is
            # served by THIS join and must not descend into a probe subtree
            # where the same name means a different column
            build_served = {r for r in refs
                            if r.startswith("b_") and r[2:] in b_schema}
            if refs and refs == build_served:
                if _has_join(node.build):
                    to_build.append(c.rename_columns(
                        {r: r[2:] for r in refs}))
                else:
                    keep.append(c)  # lands above THIS join: fusable as-is
            elif (refs <= p_schema and not build_served
                  and _has_join(node.probe)):
                to_probe.append(c)
            else:
                keep.append(c)
        new = LJoin(push_filters(node.build, tuple(to_build)),
                    push_filters(node.probe, tuple(to_probe)), node.on)
        return _wrap_filters(new, keep)
    if isinstance(node, LScan):
        return _wrap_filters(node, pending)
    raise TypeError(f"not a logical node: {node!r}")


# ---------------------------------------------------------------------------
# 2. Projection pruning
# ---------------------------------------------------------------------------

def prune_columns(node: LogicalNode,
                  needed: Optional[FrozenSet[str]] = None) -> LogicalNode:
    """Shrink scans to the columns the plan above actually references.

    ``needed=None`` means "everything" (a relation-valued root serves its
    full schema, matching legacy semantics); scalar aggregates, group-bys
    and explicit projections narrow it on the way down.  An opaque callable
    predicate forces ``None`` below it — it could read anything.
    """
    if isinstance(node, LScan):
        if needed is None:
            return node
        keep = [c for c in node.relation.names if c in needed]
        if not keep or len(keep) == len(node.relation.names):
            return node
        return LScan(node.relation.select(keep), node.name)
    if isinstance(node, LFilter):
        if needed is None or not isinstance(node.predicate, Expr):
            child_needed = None
        else:
            child_needed = needed | node.predicate.columns()
        return LFilter(prune_columns(node.child, child_needed),
                       node.predicate)
    if isinstance(node, LProject):
        cols = (node.columns if needed is None
                else tuple(c for c in node.columns if c in needed)
                or node.columns)
        return LProject(prune_columns(node.child, frozenset(cols)), cols)
    if isinstance(node, LSort):
        child_needed = None if needed is None else needed | set(node.keys)
        return LSort(prune_columns(node.child, child_needed), node.keys)
    if isinstance(node, LAggregate):
        return LAggregate(prune_columns(node.child,
                                        frozenset((node.column,))),
                          node.column, node.fn)
    if isinstance(node, LGroupBy):
        child_needed = frozenset((node.key,)) | set(node.values)
        return LGroupBy(prune_columns(node.child, child_needed), node.key,
                        node.values)
    if isinstance(node, LJoin):
        if needed is None:
            return LJoin(prune_columns(node.build),
                         prune_columns(node.probe), node.on)
        b_schema = set(schema(node.build))
        p_schema = set(schema(node.probe))
        p_needed = ({c for c in needed if c in p_schema}
                    | set(node.on))
        b_needed = ({c[2:] for c in needed
                     if c.startswith("b_") and c[2:] in b_schema}
                    | set(node.on))
        return LJoin(prune_columns(node.build, frozenset(b_needed)),
                     prune_columns(node.probe, frozenset(p_needed)),
                     node.on)
    raise TypeError(f"not a logical node: {node!r}")


# ---------------------------------------------------------------------------
# 3. Multi-key equi-join lowering: key packing
# ---------------------------------------------------------------------------

def _pack_params(build: Relation, probe: Relation, keys) -> Optional[Tuple]:
    """Range-compression parameters shared by both sides, or None when the
    combined key ranges don't fit an int64 coordinate (or keys aren't
    integers).  Reads only the cached key-cardinality sketches."""
    from .table_cache import key_stats

    lows, spans = [], []
    span_prod = 1
    for k in keys:
        if not (np.issubdtype(build[k].dtype, np.integer)
                and np.issubdtype(probe[k].dtype, np.integer)):
            return None
        bs, ps = key_stats(build, k), key_stats(probe, k)
        if bs.n == 0 or ps.n == 0:
            return None
        lo = min(int(bs.kmin), int(ps.kmin))
        hi = max(int(bs.kmax), int(ps.kmax))
        lows.append(lo)
        spans.append(hi - lo + 1)
        span_prod *= spans[-1]
        if span_prod >= 1 << 62:
            return None
    # row-major strides: last key varies fastest
    strides, acc = [0] * len(keys), 1
    for i in range(len(keys) - 1, -1, -1):
        strides[i] = acc
        acc *= spans[i]
    return tuple(zip(keys, lows, strides))


def _packed_column(rel: Relation, params) -> np.ndarray:
    """The packed int64 key coordinate, content-token cached on the relation
    so repeated queries reuse the same array object (and therefore its
    device upload — `column_token` keys on the buffer)."""
    tokens = tuple(column_token(rel[k]) for k, _, _ in params)
    with _PACK_LOCK:
        cache = rel.__dict__.setdefault("_packed_cols", {})
        hit = cache.get(params)
        if hit is not None and hit[0] == tokens:
            return hit[1]
    # the O(N) pack runs OUTSIDE the lock: the lock protects the cache
    # dicts, not the compute, and a rare racing double-pack of the same
    # relation is cheaper than serializing every session's planning
    arr = np.zeros(len(rel), np.int64)
    for k, lo, stride in params:
        arr += (rel[k].astype(np.int64) - lo) * stride
    with _PACK_LOCK:
        hit = cache.get(params)
        if hit is not None and hit[0] == tokens:
            return hit[1]  # a racer finished first; one array wins
        # drifting probe key ranges produce distinct params per query; cap
        # the range-packed entries like the factorized path caps its own
        stale = [k for k in cache if k and k[0] != "factorized"]
        for k in stale[:max(0, len(stale) - 7)]:
            del cache[k]
        cache[params] = (tokens, arr)
    return arr


def _factorized_pack(build: Relation, probe: Relation,
                     keys) -> Tuple[np.ndarray, np.ndarray]:
    """Fallback packing for non-integer or range-overflowing keys: factorize
    each key column jointly across both sides, folding progressively with a
    re-factorization per step so the accumulator range stays bounded.

    The result depends on BOTH sides' content, so it is cached on the build
    relation keyed by (keys, probe identity) with both sides' key-column
    tokens as the staleness check — repeated serving queries skip the
    per-key np.unique passes (and, because the arrays are reused, their
    device uploads), including workloads that alternate one build table
    against several probe tables."""
    keys = tuple(keys)
    probe_tokens = tuple(column_token(probe[k]) for k in keys)
    tokens = (tuple(column_token(build[k]) for k in keys), probe_tokens)
    ck = ("factorized", keys, probe_tokens)
    with _PACK_LOCK:
        cache = build.__dict__.setdefault("_packed_cols", {})
        hit = cache.get(ck)
        if hit is not None and hit[0] == tokens:
            return hit[1]
    # the np.unique factorization passes run OUTSIDE the lock (see
    # _packed_column): a racing duplicate pack beats serialized planning
    nb = len(build)
    acc = np.zeros(nb + len(probe), np.int64)
    for k in keys:
        comb = np.concatenate([np.asarray(build[k]),
                               np.asarray(probe[k])])
        _, inv = np.unique(comb, return_inverse=True)
        merged = acc * (int(inv.max(initial=0)) + 1) + inv
        _, acc = np.unique(merged, return_inverse=True)
        acc = acc.astype(np.int64)
    out = (np.ascontiguousarray(acc[:nb]), np.ascontiguousarray(acc[nb:]))
    with _PACK_LOCK:
        hit = cache.get(ck)
        if hit is not None and hit[0] == tokens:
            return hit[1]
        # per-probe entries let one build table alternate against several
        # probe tables without thrash, but a stream of ad-hoc probes must
        # not grow the build's cache without bound: evict the oldest beyond
        # a small cap
        stale = [k for k in cache if k[0] == "factorized" and k[1] == keys]
        for k in stale[:max(0, len(stale) - 7)]:
            del cache[k]
        cache[ck] = (tokens, out)
    return out


def _with_pack(rel: Relation, arr: np.ndarray) -> Relation:
    aug = rel.select(rel.names)  # shares the device-cache dicts
    aug.columns[PACK_COL] = np.ascontiguousarray(arr)
    return aug


def pack_pair(build: Relation, probe: Relation,
              keys) -> Tuple[Relation, Relation]:
    """Augment both relations with a shared single-column join coordinate
    ``PACK_COL`` such that packed equality ⟺ key-tuple equality."""
    for rel in (build, probe):
        if PACK_COL in rel.names:
            raise ValueError(
                f"column name {PACK_COL!r} is reserved for multi-key join "
                f"packing; rename it before joining on multiple keys")
    params = _pack_params(build, probe, keys)
    if params is not None:
        return (_with_pack(build, _packed_column(build, params)),
                _with_pack(probe, _packed_column(probe, params)))
    bp, pp = _factorized_pack(build, probe, keys)
    return _with_pack(build, bp), _with_pack(probe, pp)


# ---------------------------------------------------------------------------
# 4. Fragment extraction → chained physical stages
# ---------------------------------------------------------------------------

def _merge_preds(preds):
    if len(preds) == 1:
        return preds[0]
    if all(isinstance(p, Expr) for p in preds):
        return reduce(operator.and_, preds)
    return CombinedPredicate(preds)


@dataclasses.dataclass
class Stage:
    """One physical execution unit: a join fragment or a single-table chain.

    ``ops`` is bottom-up; sources are ``("rel", Relation)`` for base tables
    or ``("stage", i)`` for a previous stage's output.
    """

    join: Optional[Tuple[object, object, Tuple[str, ...]]]
    input: Optional[Tuple]
    ops: Tuple

    def build_physical(self, outputs: List[Optional[Relation]]):
        from .executor import (Aggregate, Filter, GroupBy, Join, Project,
                               Scan, Sort)

        def resolve(src):
            return outputs[src[1]] if src[0] == "stage" else src[1]

        if self.join is not None:
            bsrc, psrc, on = self.join
            brel, prel = resolve(bsrc), resolve(psrc)
            if len(on) == 1:
                node = Join(Scan(brel), Scan(prel), on[0])
            else:
                brel, prel = pack_pair(brel, prel, on)
                node = Join(Scan(brel), Scan(prel), PACK_COL)
        else:
            node = Scan(resolve(self.input))
        for op in self.ops:
            kind = op[0]
            if kind == "filter":
                node = Filter(node, op[1])
            elif kind == "sort":
                node = Sort(node, list(op[1]))
            elif kind == "project":
                node = Project(node, list(op[1]))
            elif kind == "group_by":
                node = GroupBy(node, op[1], dict(op[2]))
            elif kind == "agg":
                node = Aggregate(node, op[1], op[2])
            else:
                raise ValueError(kind)
        return node

    def describe(self) -> str:
        if self.join is not None:
            bsrc, psrc, on = self.join
            src = (f"join[{','.join(on)}]("
                   f"{_src_name(bsrc)}, {_src_name(psrc)})")
            if len(on) > 1:
                src += " (packed)"
        else:
            src = f"scan({_src_name(self.input)})"
        parts = [src]
        for op in self.ops:
            if op[0] == "filter":
                parts.append(f"filter({op[1]!r})"
                             if isinstance(op[1], Expr) else "filter(<fn>)")
            elif op[0] == "sort":
                parts.append(f"sort{list(op[1])}")
            elif op[0] == "project":
                parts.append(f"project{list(op[1])}")
            elif op[0] == "group_by":
                parts.append(f"group_by[{op[1]}]{dict(op[2])}")
            elif op[0] == "agg":
                parts.append(f"agg[{op[2]}({op[1]})]")
        return " → ".join(parts)


def _src_name(src) -> str:
    if src[0] == "stage":
        return f"#{src[1]}"
    rel = src[1]
    return f"rel[{len(rel)}x{len(rel.names)}]"


@dataclasses.dataclass
class Program:
    """An ordered chain of physical stages; each stage's output feeds later
    stages by index.  Running a program walks the chain through ONE executor
    so every fragment is priced by the same selector/profile and all metrics
    merge into a single :class:`~repro_torch.core.executor.QueryResult`."""

    stages: List[Stage]
    scalar: bool

    def run(self, executor):
        from .executor import QueryResult

        outputs: List[Optional[Relation]] = []
        metrics, decisions = [], []
        result = None
        for stage in self.stages:
            result = executor.execute(stage.build_physical(outputs))
            metrics.extend(result.metrics)
            decisions.extend(result.decisions)
            outputs.append(result.relation)
        return QueryResult(result.relation, result.scalar, metrics,
                           decisions)

    def explain(self) -> str:
        lines = [f"stage {i}: {s.describe()}"
                 for i, s in enumerate(self.stages)]
        return "\n".join(lines)


def _source(node, stages) -> Tuple:
    if isinstance(node, LScan):
        return ("rel", node.relation)
    return ("stage", _compile_stage(node, stages))


def _compile_stage(node, stages) -> int:
    """Peel the wrapper chain down to this subtree's core (join or scan),
    sink filters to sit directly above the join (the fused-fragment shape),
    and emit one Stage.  Join children that are themselves plan subtrees
    become their own (earlier) stages."""
    wrappers = []
    cur = node
    while isinstance(cur, (LFilter, LSort, LProject, LGroupBy, LAggregate)):
        wrappers.append(cur)
        cur = cur.child
    wrappers.reverse()  # inner (nearest core) → outer

    ops: List[Tuple] = []
    if isinstance(cur, LJoin):
        join = (_source(cur.build, stages), _source(cur.probe, stages),
                tuple(cur.on))
        input_src = None
        # sink filters below sorts/projects (they commute) so the stage
        # matches Join→Filter→Sort→Aggregate; aggregation is a barrier
        sink, rest, barrier = [], [], False
        for w in wrappers:
            if isinstance(w, LFilter) and not barrier:
                sink.append(w.predicate)
            else:
                if isinstance(w, (LGroupBy, LAggregate)):
                    barrier = True
                rest.append(w)
        if sink:
            ops.append(("filter", _merge_preds(sink)))
        wrappers = rest
        if len(cur.on) > 1 and not any(
                isinstance(w, (LGroupBy, LAggregate, LProject))
                for w in wrappers):
            # relation-rooted packed stage: drop the synthetic coordinate
            # and the build side's duplicated key columns at the root (an
            # aggregation/explicit projection root already excludes them)
            wrappers.append(LProject(None, schema(cur)))
    else:
        join = None
        input_src = ("rel", cur.relation)
    for w in wrappers:
        if isinstance(w, LFilter):
            ops.append(("filter", w.predicate))
        elif isinstance(w, LSort):
            ops.append(("sort", tuple(w.keys)))
        elif isinstance(w, LProject):
            ops.append(("project", tuple(w.columns)))
        elif isinstance(w, LGroupBy):
            ops.append(("group_by", w.key, tuple(w.values.items())))
        elif isinstance(w, LAggregate):
            ops.append(("agg", w.column, w.fn))
    stages.append(Stage(join, input_src, tuple(ops)))
    return len(stages) - 1


def plan_program(plan, rewrite: bool = True) -> Program:
    """Plan a logical (or legacy physical) tree into a chained-stage
    physical program.  ``rewrite=False`` skips the pushdown/pruning
    rewrites for A/B measurement; fragment chaining and multi-key packing
    are structural lowering and always apply."""
    from .executor import PHYSICAL_NODES

    if isinstance(plan, PHYSICAL_NODES):
        plan = from_physical(plan)
    if rewrite:
        plan = push_filters(plan)
        plan = prune_columns(plan)
    stages: List[Stage] = []
    _compile_stage(plan, stages)
    return Program(stages, scalar=is_scalar(plan))
