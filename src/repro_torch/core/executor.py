"""Mini cost-based execution engine with *deferred decision points*.

A tiny physical-operator tree (Scan / Filter / Join / Sort / Aggregate) that
models the structure the paper critiques and the fix it proposes:

  * a traditional plan fixes each operator's execution path at *plan time*
    (``policy="linear"`` or ``"tensor"`` pins every operator);
  * the paper's design (``policy="auto"``) leaves join/sort decision points
    *open* and resolves them at execution time via :class:`PathSelector`,
    using the actually-observed input relations.

Tensor-path execution is **device-resident**: once an operator lands on the
tensor path its output stays on device as a :class:`DeviceRelation` (lazy
gather indices + validity mask), downstream tensor operators chain without
any host round trip, and materialization happens exactly once at the query
root (reported as a ``materialize`` entry in the metrics with its host-sync
count).  Recognized ``Join→[Filter]→[Sort]→[Aggregate]`` fragments run
as a single fused device program (see :mod:`repro_torch.core.fused`) that
pays ≤ 1 device→host transfer for the whole query.

Tensor-path work runs on the executor's ``device``: CUDA unless the caller
asks for the CPU.

The executor records per-operator :class:`OpMetrics` so benchmarks can report
latency, Temp_MB, working-set peaks and host-sync counts per path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

import torch

from ..device import resolve_device, to_host
from .device_relation import DeviceRelation
from .faults import (DeviceDispatchError, FaultInjector, PreemptedError,
                     RetryPolicy, TransientError)
from .guards import SwitchPoint
from .linear_engine import hash_join_linear, sort_linear
from .memory_governor import MemoryGovernor
from .metrics import OpMetrics, SpillAccount, Timer
from .path_selector import Decision, PathSelector
from .relation import Relation
from .resource_broker import (PreemptToken, PressureQuote, ResourceBroker,
                              ResourceRequest, default_broker)
from .spill import SpillManager
from .tensor_engine import (dense_join_domain, tensor_join_device,
                            tensor_sort_device)
from .tier import TierConfig, TierLedger, TierManager

__all__ = ["Scan", "Filter", "Join", "Sort", "Aggregate", "GroupBy",
           "Project", "PHYSICAL_NODES", "Executor", "QueryResult"]


# -- logical plan nodes ------------------------------------------------------

@dataclasses.dataclass
class Scan:
    relation: Relation
    name: str = "scan"


@dataclasses.dataclass
class Filter:
    """Row-wise selection.

    ``predicate`` must be a ROW-WISE (element-wise) expression over the
    relation's columns returning a boolean mask — the relational WHERE
    contract.  On the device-resident paths it may be evaluated over a
    capacity-padded physical row space (masked rows included), so
    whole-column aggregates inside a predicate (e.g. ``r['w'].mean()``)
    are out of contract and would see padding.
    """
    child: object
    predicate: Callable[[Relation], np.ndarray]  # rows mask
    name: str = "filter"


@dataclasses.dataclass
class Join:
    build: object
    probe: object
    key: str
    name: str = "join"


@dataclasses.dataclass
class Sort:
    child: object
    keys: Sequence[str]
    name: str = "sort"


@dataclasses.dataclass
class Aggregate:
    child: object
    column: str
    fn: str = "sum"  # sum | count | min | max
    name: str = "aggregate"


@dataclasses.dataclass
class GroupBy:
    child: object
    key: str
    values: dict  # column -> agg fn
    name: str = "group_by"


@dataclasses.dataclass
class Project:
    """Column subset.  Structural (dict-slice / lazy-column-slice) on both
    regimes — never a data movement; the planner uses it to serve pruned
    output schemas (e.g. dropping a packed join coordinate)."""

    child: object
    columns: Sequence[str]
    name: str = "project"


# the closed set of physical plan nodes; Executor.execute and the planner's
# legacy detection both key off this one tuple (add new nodes HERE)
PHYSICAL_NODES = (Scan, Filter, Join, Sort, Aggregate, GroupBy, Project)

# Process-wide registry of per-operator device shape signatures that have
# already run once (their one-off first-call costs — kernel library load,
# allocator growth — are paid).  Exact row counts on purpose: bucketing
# would classify a genuinely-fresh shape as warm.  Capped as a backstop:
# overflow clears the registry, costing at most one extra unleased run per
# shape.
import threading as _threading

_WARM_SIGS: set = set()
_WARM_SIG_LOCK = _threading.Lock()
_WARM_SIGS_CAP = 4096


@dataclasses.dataclass
class QueryResult:
    relation: Optional[Relation]
    scalar: Optional[float]
    metrics: List[OpMetrics]
    decisions: List[Decision]

    @property
    def total_wall_s(self) -> float:
        return sum(m.wall_s for m in self.metrics)

    @property
    def total_temp_mb(self) -> float:
        return sum(m.spill.temp_mb for m in self.metrics)

    @property
    def total_host_syncs(self) -> int:
        return sum(m.host_syncs for m in self.metrics)

    @property
    def total_h2d_bytes(self) -> int:
        """Host→device bytes this query PHYSICALLY transferred (0 when every
        base table was already resident in the device column cache; packed
        codes + dictionaries when compressed layouts are on)."""
        return sum(m.h2d_bytes for m in self.metrics)

    @property
    def total_h2d_bytes_logical(self) -> int:
        """The same transfers priced at logical column width — the upload
        cost without packed device layouts.  physical/logical is the
        query's effective H2D compression ratio."""
        return sum(m.h2d_bytes_logical for m in self.metrics)


class Executor:
    """Walks a plan; resolves deferred join/sort decision points at run time."""

    def __init__(self, work_mem: int, policy: str = "auto",
                 selector: Optional[PathSelector] = None,
                 spill_root: Optional[str] = None,
                 fuse: bool = True,
                 governor: Optional[MemoryGovernor] = None,
                 broker: Optional[ResourceBroker] = None,
                 faults: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 max_shards: int = 1,
                 tiers: Optional[TierConfig] = None,
                 guards: bool = True, device="cuda"):
        if policy not in ("auto", "linear", "tensor"):
            raise ValueError(policy)
        # the device every tensor-path operator of this executor runs on;
        # asking for CUDA without a card raises here, never later
        self.device = resolve_device(device)
        if int(max_shards) < 1:
            raise ValueError(f"max_shards must be >= 1, got {max_shards}")
        # Spill-tier hierarchy: when configured, every per-query spill sink
        # becomes a TierManager (T0 compressed host RAM → T1 emulated
        # remote → T2 disk) instead of the flat disk SpillManager, and the
        # selector prices the tiered-linear candidate.  ``tiers=True``
        # enables the default hierarchy.
        if tiers is True:
            tiers = TierConfig()
        self.tiers = tiers
        # Session-lifetime balance ledger: every per-query TierManager
        # absorbs its per-tier byte counters (and any leaked pool bytes)
        # here at cleanup; verify_balanced() is the leak/imbalance gate.
        self.tier_ledger = TierLedger() if tiers is not None else None
        force = None if policy == "auto" else policy
        self.selector = selector or PathSelector(work_mem, force=force,
                                                 tiers=tiers)
        if selector is not None and force is not None:
            self.selector.force = force
        # the selector prices pending uploads against this device's cache
        self.selector.device = self.device
        if selector is not None and tiers is not None \
                and getattr(selector, "tiers", None) is None:
            selector.tiers = tiers
        self.work_mem = work_mem
        self.spill_root = spill_root
        self.fuse = fuse
        # Every resource acquisition goes through ONE broker: memory leases
        # for linear operators (when a governor exists), device leases for
        # fused and per-operator tensor dispatch, and the pressure quotes
        # the selector folds into path costs.  A governor without a broker
        # gets a private broker; no governor falls back to the process-wide
        # default broker (device-only — its queue is THE queue for every
        # broker-less session, preserving one-device serialization).
        if broker is None:
            # an auto-built broker SHARES the process-wide device queue:
            # the physical device is one resource however many governed
            # sessions exist, and a private queue here would let two
            # sessions' fused programs time-slice against each other —
            # the tail the queue exists to remove.  Per-server private
            # queues are an explicit choice (QueryServer passes one).
            broker = (ResourceBroker(governor,
                                     device_queue=default_broker().device)
                      if governor is not None else default_broker())
        elif governor is not None and broker.governor is not governor:
            raise ValueError(
                "pass either governor or broker (or a broker built over "
                "that governor); conflicting governors would split the "
                "budget accounting")
        self.broker = broker
        # Shared memory governor (concurrent serving): linear operators
        # acquire a grant before building their linearized intermediate and
        # the GRANT size — not the static work_mem — bounds their memory.
        # None keeps the single-query semantics: a private work_mem.
        self.governor = governor if governor is not None else broker.governor
        # Fault handling: the injector (also reachable through the broker,
        # which owns the device/grant sites) feeds the spill-write site via
        # the per-query SpillManager; the retry policy drives the
        # TransientError backoff loop and the device path-fallback
        # threshold.  Thread-local state because one executor serves many
        # worker threads: a device failing for THIS query must not pin a
        # neighbor's path.
        self.faults = faults if faults is not None else broker.faults
        self.retry = retry if retry is not None else RetryPolicy()
        # Lane fan-out ceiling for fused fragments: 1 (default) keeps every
        # dispatch on the single-device path; N > 1 lets choose_fragment
        # price the partition-parallel sharded program (capped at the
        # device's logical lanes at decision time) and run_fused fan out
        # over N broker lanes when it wins.
        self.max_shards = int(max_shards)
        # Execution-time guards (mid-query adaptive re-planning): when on,
        # every costed LINEAR join/sort runs under an ExecutionGuard that
        # re-checks the decision at partition boundaries and can abandon a
        # mispriced operator for the tensor path mid-query, reusing its
        # already-spilled partitions.  ``guards=False`` is the static-
        # decision ablation the fig14 robustness map measures against.
        self.guards = bool(guards)
        self._tls = _threading.local()

    # -- memory grants -------------------------------------------------------
    def _effective_work_mem(self, need_bytes: Optional[int] = None) -> int:
        """The work_mem a linear operator would receive *right now*.
        Decision-time pricing goes through :meth:`_quotes` (grant size AND
        expected waits); this remains the plain grant-size peek for
        diagnostics and callers that only need the memory half.

        ``need_bytes`` (the operator's estimated linearized-intermediate
        footprint) makes the probe EXACTLY the request :meth:`_granted`
        would make, so full-or-floor pricing matches the grant the operator
        would actually receive.  Without it the probe is capped at the
        governor's whole budget — a work_mem larger than the pool itself
        would otherwise read as permanent pressure even when idle."""
        if self.governor is None:
            return self.work_mem
        if need_bytes is None:
            req = min(self.work_mem, self.governor.total_bytes)
        else:
            req = min(self.work_mem, max(1, int(need_bytes)))
        return self.governor.would_grant(req)

    def _quotes(self, need_bytes: int, lanes: int = 1):
        """Broker pricing for one deferred decision: ``(mem_quote,
        dev_quote, reservation)``.  The memory quote is probed with EXACTLY
        the request :meth:`_granted` would make (same ``min(work_mem,
        need)`` sizing), so grant pricing and admission-wait pricing
        describe the queue the operator would actually stand in; the device
        quote prices the dispatch queue the tensor path would join.

        Under a governed broker the memory quote arrives as a
        price-and-hold :class:`~repro_torch.core.resource_broker.Reservation`:
        the quoted bytes are committed until the decision converts the hold
        (linear path — pass the reservation to :meth:`_granted`) or cancels
        it (tensor path / any exception; the caller's ``finally`` must
        cancel, and the TTL backstops leaks).  A forced-policy selector
        never reads quotes — skip the lock-acquiring pricing on that hot
        path."""
        if self.selector.force is not None:
            return None, None, None
        rsv = None
        if self.broker.governor is not None:
            req = min(self.work_mem, max(1, int(need_bytes)))
            rsv = self.broker.reserve(ResourceRequest("memory",
                                                      need_bytes=req))
            mem = rsv.quote
        else:
            # ungoverned: a synthetic full-grant quote at the EXECUTOR's
            # work_mem, preserving the pre-broker contract that decisions
            # are priced against the executor's budget even when the
            # selector was constructed with a different one
            mem = PressureQuote("memory", self.work_mem, 0.0, 0, False)
        dev = self.broker.price(ResourceRequest("device",
                                                lanes=max(1, int(lanes))))
        return mem, dev, rsv

    @contextlib.contextmanager
    def _granted(self, need_bytes: int, reservation=None):
        """Grant scope for one linear operator: yields ``(work_mem, lease)``
        where ``work_mem`` is what the operator must live within and
        ``lease`` is None for ungoverned executors.  Requests the smaller
        of the configured work_mem and the operator's estimated
        linearized-intermediate footprint, so small operators under a
        shared budget don't hoard memory they cannot use.  ``reservation``
        redeems a :meth:`_quotes` hold: the decision's quoted bytes convert
        into the grant with zero admission wait (decide-then-lose closed)."""
        if self.broker.governor is None:
            yield self.work_mem, None
            return
        lease = self.broker.memory_lease(
            min(self.work_mem, max(1, int(need_bytes))),
            reservation=reservation)
        try:
            yield lease.size, lease
        finally:
            lease.release()

    # -- preemption ----------------------------------------------------------
    def _preempt_token(self, lease) -> Optional[PreemptToken]:
        """Register a floor-degraded linear operator as preemptible.  A full
        grant runs as fast as it ever will — only the degraded case (the
        spill wall) is worth abandoning for a tensor requeue."""
        if lease is None or not lease.degraded:
            return None
        token = PreemptToken()
        self.broker.register_preemptible(token)
        return token

    def _drop_token(self, token: Optional[PreemptToken]) -> None:
        if token is not None:
            self.broker.unregister_preemptible(token)

    # -- execution-time guards (mid-query re-planning) -----------------------
    def _guard(self, decision: Decision, op: str, rows_in: int, token):
        """Cancel token for one linear operator: the selector's
        ExecutionGuard when guards are on (wrapping the preempt token so
        broker preemption keeps working through it), else the bare token."""
        return self.selector.make_guard(decision, op, rows_in, token=token,
                                        enabled=self.guards)

    @staticmethod
    def _stamp_switch(m: OpMetrics, sp: SwitchPoint, pre_path: str) -> None:
        """Account a mid-query switch on the metrics of the run that
        finished the operator: the abandoned attempt's wall joins wall_s
        (end-to-end honesty) but is held in pre_switch_wall_s under
        pre_switch_path so profile feedback attributes each half to the
        path that actually burned it."""
        m.switched = True
        m.pre_switch_wall_s = sp.elapsed_s
        m.pre_switch_path = pre_path
        m.wall_s += sp.elapsed_s
        m.decision_reason = sp.reason

    def _complete_join_switch(self, sp: SwitchPoint, key: str, mgr,
                              rows_in: int, pre_path: str):
        """Finish a guard-abandoned Grace join on the tensor path WITHOUT
        losing the linear prefix's work.

        ``sp.done`` partitions are already joined and kept as-is;
        ``sp.pending`` pairs are read back from the spill/tier manager
        (byte-accounted on the operator's own SpillAccount, so the tier
        books stay balanced), deleted, concatenated, and joined by ONE
        :func:`~repro_torch.core.tensor_engine.tensor_join_device` gang
        dispatch.  One dispatch instead of per-pair calls is what makes
        the switch profitable at all: the per-pair fixed cost (~dispatch
        + 2 syncs) is on the order of the linear loop's per-pair work,
        so a pairwise takeover would only break even.  The output stays
        device-resident (like the normal tensor walk) whenever there is
        no host prefix to splice in front of it — materializing the
        joined output to host costs more than the join itself.
        Concatenation is safe AND byte-identical to per-pair joins:
        Grace hash-partitions by key, so every build row for a key lives
        in exactly one partition, the concatenated probe preserves
        (partition, within-partition) order, and the join's stable build
        ordering makes each probe row's match list independent of the
        other partitions' rows."""
        from .tensor_engine import tensor_join, tensor_join_device

        spill = sp.spill if sp.spill is not None else SpillAccount()
        results = list(sp.done)
        reused = 0
        h2d = 0
        h2d_log = 0
        live = [(b, p, nb, npr) for b, p, nb, npr in sp.pending
                if b is not None and p is not None and nb and npr]
        sig = ("switch_join", key, sum(x[2] for x in live),
               sum(x[3] for x in live))
        syncs = 0
        with self._device_leased(sig) as lease:
            with Timer() as t:
                for b_path, p_path, nb, npr in sp.pending:
                    if (b_path is None or p_path is None
                            or nb == 0 or npr == 0):
                        for p in (b_path, p_path):
                            if p:
                                mgr.delete(p, spill)
                        continue
                builds, probes = [], []
                for b_path, p_path, nb, npr in live:
                    b_part = mgr.read_relation(b_path, spill)
                    p_part = mgr.read_relation(p_path, spill)
                    reused += b_part.nbytes() + p_part.nbytes()
                    mgr.delete(b_path, spill)
                    mgr.delete(p_path, spill)
                    builds.append(b_part)
                    probes.append(p_part)
                gang = None
                if builds:
                    b_all = builds[0]
                    for b in builds[1:]:
                        b_all = b_all.concat(b)
                    p_all = probes[0]
                    for p in probes[1:]:
                        p_all = p_all.concat(p)
                    dev_b, up_b, log_b = self._to_device(b_all)
                    dev_p, up_p, log_p = self._to_device(p_all)
                    h2d += up_b + up_p
                    h2d_log += log_b + log_p
                    gang, pm = tensor_join_device(
                        dev_b, dev_p, key,
                        dense=dense_join_domain(b_all, key))
                    syncs += pm.host_syncs
                if not results and gang is not None:
                    # no host prefix: hand the takeover result downstream
                    # device-resident, exactly like the tensor walk would
                    out = gang
                elif gang is None and not results:
                    # all partitions empty: schema-correct empty result
                    b_schema, p_schema = sp.schema_hint
                    empty_b = Relation(
                        {k: v[:0] for k, v in b_schema.items()})
                    empty_p = Relation(
                        {k: v[:0] for k, v in p_schema.items()})
                    out, pm = tensor_join(empty_b, empty_p, key,
                                          device=self.device)
                    syncs += pm.host_syncs
                else:
                    if gang is not None:
                        results.append(gang.to_host())
                        syncs += 1
                    out = results[0]
                    for r in results[1:]:
                        out = out.concat(r)
        m = OpMetrics(op="hash_join", path="tensor", rows_in=rows_in,
                      rows_out=len(out), wall_s=t.elapsed, spill=spill,
                      host_syncs=syncs, reused_spill_bytes=reused)
        m.h2d_bytes += h2d
        m.h2d_bytes_logical += h2d_log
        self._stamp_lease(m, lease)
        self._stamp_switch(m, sp, pre_path)
        self.broker.note_switch()
        return out, m

    # -- transient-fault handling --------------------------------------------
    def _forced_linear(self) -> bool:
        return getattr(self._tls, "force_path", None) == "linear"

    def _decide(self, decision: Decision) -> Decision:
        """Apply this thread's device path-fallback to a selector decision:
        after repeated device-dispatch failures the rest of the query runs
        linear whatever the costs say — the selector prices a healthy
        device, and the fault counter is the evidence it is wrong."""
        if decision.path == "tensor" and self._forced_linear():
            return dataclasses.replace(
                decision, path="linear",
                reason="device-fallback: " + decision.reason)
        return decision

    def _note_transient(self, exc: TransientError) -> None:
        """Per-thread failure accounting: repeated device-dispatch failures
        pin the REST of this thread's current query onto the linear path
        (path fallback) — a sick device must degrade service, not abort it."""
        if isinstance(exc, DeviceDispatchError):
            fails = getattr(self._tls, "device_failures", 0) + 1
            self._tls.device_failures = fails
            if fails >= self.retry.device_fallback_after:
                self._tls.force_path = "linear"

    def _reset_fault_state(self) -> None:
        self._tls.force_path = None
        self._tls.device_failures = 0

    @contextlib.contextmanager
    def _device_leased(self, sig: object = None):
        """Device lease scope for one per-operator tensor dispatch.  The
        shared ``"per-op"`` batch bucket lets concurrent per-operator work
        coalesce with itself (its device programs are small and lazy) while
        still queueing, in arrival order, behind exclusive fused dispatches.
        The lease wait is load, not cost: callers stamp it into
        ``OpMetrics.queue_wait_s`` so profile feedback excludes it.

        ``sig`` is the call's shape signature: its FIRST sighting process-
        wide runs without a lease (yields None), because a first call pays
        one-off costs that must not stall every other query's device phase
        inside the queue.  This mirrors ``run_fused``'s fresh-program
        bypass; per-op calls have no program cache to ask, so the signature
        registry is the freshness oracle (approximate is fine — a
        misclassification costs one unqueued warm run or one queued cold
        one, never a wrong result)."""
        if sig is not None:
            with _WARM_SIG_LOCK:
                fresh = sig not in _WARM_SIGS
            if fresh:
                yield None
                # registered only on normal completion: a run that raised
                # may never have paid its first-call costs, and treating
                # the shape as warm would put them INSIDE an exclusive
                # lease — the stall this bypass exists to avoid
                with _WARM_SIG_LOCK:
                    if len(_WARM_SIGS) >= _WARM_SIGS_CAP:
                        _WARM_SIGS.clear()
                    _WARM_SIGS.add(sig)
                return
        lease = self.broker.device_lease(batch_key="per-op")
        try:
            yield lease
        finally:
            lease.release()

    @staticmethod
    def _stamp_grant(m: OpMetrics, grant) -> None:
        if grant is not None:
            m.grant_bytes = grant.size
            m.grant_degraded = grant.degraded
            m.mem_wait_s = grant.wait_s

    @staticmethod
    def _stamp_lease(m: OpMetrics, lease) -> None:
        """Device-lease accounting: the wait is end-to-end latency (added
        to wall_s) but contention noise for the runtime profile (mirrored
        into queue_wait_s, which feedback subtracts — the fix for the
        ROADMAP-noted per-operator profile pollution)."""
        if lease is not None:
            m.wall_s += lease.wait_s
            m.queue_wait_s += lease.wait_s
            m.batched = m.batched or lease.batched

    def execute(self, plan) -> QueryResult:
        if not isinstance(plan, PHYSICAL_NODES):
            # logical IR (or a fluent Query): route through the rewrite
            # planner, which chains physical fragments back through this
            # executor — same selector, same profile, merged metrics.
            # This is the QUERY boundary: per-thread fault state (device
            # failure count, forced path) resets here so one query's sick
            # device never pins the next query linear.
            from .planner import plan_program

            node = plan.logical() if hasattr(plan, "logical") else plan
            self._reset_fault_state()
            try:
                return plan_program(node).run(self)
            finally:
                self._reset_fault_state()
        # Physical fragment: retry TransientErrors with exponential backoff
        # + jitter.  Fragments are pure (inputs are immutable relations; all
        # scratch state — spill manager, leases, holds — is per-attempt and
        # released on the way out), so re-running one is safe.  Planner
        # stages re-enter here per fragment, which scopes the retry to the
        # failed fragment instead of the whole multi-stage program.
        attempt = 0
        while True:
            attempt += 1
            try:
                return self._execute_physical(plan)
            except TransientError as exc:
                self._note_transient(exc)
                if attempt >= self.retry.max_attempts:
                    raise
                time.sleep(self.retry.backoff(attempt))

    def _execute_physical(self, plan) -> QueryResult:
        metrics: List[OpMetrics] = []
        decisions: List[Decision] = []

        # fused device-resident fast path for recognized fragments
        self._tls.fragment_switch = None
        if (self.fuse and self.selector.force != "linear"
                and not self._forced_linear()):
            fused = self._try_fused(plan, metrics, decisions)
            if fused is not None:
                return fused

        with self._spill_manager() as mgr:
            out = self._exec(plan, metrics, decisions, mgr)
            out = self._materialize_root(out, metrics)
        result = (QueryResult(out, None, metrics, decisions)
                  if isinstance(out, Relation)
                  else QueryResult(None, float(out), metrics, decisions))
        sw = getattr(self._tls, "fragment_switch", None)
        if sw is not None and metrics:
            # a fragment guard abandoned the fused tensor attempt before
            # this walk: stamp the abandoned wall on the root-most metric so
            # end-to-end accounting (and ServedQuery.switched) see it
            self._tls.fragment_switch = None
            pre_wall, reason = sw
            m0 = metrics[-1]
            m0.switched = True
            m0.pre_switch_wall_s = pre_wall
            m0.pre_switch_path = "tensor"
            m0.wall_s += pre_wall
            m0.decision_reason = (m0.decision_reason + "; " + reason
                                  if m0.decision_reason else reason)
        self._record_profile(metrics)
        self._record_fragment(plan, decisions, metrics)
        return result

    def _spill_manager(self):
        """Per-query spill sink: the flat disk :class:`SpillManager`, or —
        when the session configures a tier hierarchy — a
        :class:`TierManager` routing spilled partitions/runs through
        compressed host RAM and the emulated remote tier before disk,
        absorbing its byte counters into the session-lifetime ledger at
        cleanup."""
        if self.tiers is None:
            return SpillManager(self.spill_root, faults=self.faults)
        return TierManager(root=self.spill_root, config=self.tiers,
                           faults=self.faults, retry=self.retry,
                           ledger=self.tier_ledger)

    @staticmethod
    def _apply_tier_quota(mgr, grant) -> None:
        """Scope a tiered grant's per-tier spill quotas onto the per-query
        tier manager before a linear operator spills.  No-op for the flat
        SpillManager or a plain (untiered) grant."""
        setq = getattr(mgr, "set_op_quota", None)
        if setq is None:
            return
        quotas = None if grant is None else getattr(grant, "tier_quotas",
                                                    None)
        if quotas is not None:
            setq(quotas)

    # -- runtime feedback ---------------------------------------------------
    def _record_profile(self, metrics, verified_warm: bool = False) -> None:
        """Feed observed (op, path, size-bucket) → wall_s back into the
        selector's runtime profile — the loop that self-corrects the
        crossover point without recalibration.

        Tensor-path samples carry a warmup discard unless the caller proved
        the run was warm (``verified_warm``): the per-operator tensor path
        cannot cheaply detect a cold first call, and one cold wall entering
        a cold cell would flip the selector to linear and keep it there.
        Linear ops have no cold first call and always record."""
        prof = getattr(self.selector, "profile", None)
        if prof is None:
            return
        for m in metrics:
            # contention is load, not execution cost (admission owns load;
            # the model owns cost), so two classes of wall never enter the
            # blend: device-queue wait, and linear walls from DEGRADED
            # grants — a spill forced by a squeezed grant says nothing
            # about the operator's full-memory cost, and one multi-second
            # burst sample would latch the cell against linear long after
            # the pressure drains
            if m.grant_degraded:
                continue
            if m.switched:
                # a guard-switched operator is a HYBRID: part linear prefix,
                # part tensor completion over the reused partitions.  Its
                # wall describes neither pure path — splitting it at the
                # switch boundary still records a partial attempt against
                # cells that price FULL runs, so the sample is dropped
                # entirely (the pre-PR behavior charged the whole mixed wall
                # to the final path's cell, poisoning its estimate).
                continue
            # the abandoned pre-switch attempt's wall (preemption requeue)
            # is excluded the same way: only the finishing run's own cost
            # enters its path's cell
            prof.record(m.op, m.path, m.rows_in,
                        m.wall_s - m.queue_wait_s - m.pre_switch_wall_s,
                        warmup_discard=(m.path == "tensor"
                                        and not verified_warm))

    def _record_fragment(self, plan, decisions, metrics) -> None:
        """When the plan WAS a fusable fragment but ran on the generic walk,
        record its end-to-end wall so choose_fragment's blend sees
        linear-fragment observations too.  Only all-LINEAR walks qualify:
        a mixed walk is an observation of neither fragment path, and a pure
        per-operator tensor walk is NOT the fused program choose_fragment
        prices (it is 2-3.5x slower; recording it as ('fragment','tensor')
        would bias the blend against fusion).  The fused dispatcher records
        its own tensor-fragment observations."""
        if not self.fuse or not decisions:
            return
        if {d.path for d in decisions} != {"linear"}:
            return
        if any(m.grant_degraded for m in metrics):
            return  # squeezed-grant spill wall: load, not fragment cost
        if any(m.preempted or m.switched for m in metrics):
            # the walk did NOT run all-linear even though the decisions say
            # so: a preemption or guard switch finished part of it on the
            # tensor path, and recording that wall against the linear
            # fragment cell is exactly the cross-path pollution this guard
            # exists to stop (regression-tested)
            return
        prof = getattr(self.selector, "profile", None)
        if prof is None:
            return
        from .fused import match_fragment

        frag = match_fragment(plan)
        if frag is None:
            return
        _, build, probe = frag
        # Under a configured tier hierarchy every linear spill routed
        # through the TierManager, so a spilling walk is an observation of
        # the TIERED linear fragment — it feeds the staircase's own profile
        # cell.  Spill-free walks are identical on both variants.
        spilled = any(d.predicted_spill_bytes > 0 for d in decisions) \
            or any(m.spill.bytes_written > 0 for m in metrics)
        frag_path = ("linear_tiered"
                     if self.tiers is not None and spilled else "linear")
        prof.record("fragment", frag_path, len(build) + len(probe),
                    sum(m.wall_s for m in metrics))

    # -- fused fragment dispatch -------------------------------------------
    def _try_fused(self, plan, metrics, decisions) -> Optional[QueryResult]:
        from .fused import PredicateError, match_fragment, run_fused

        frag = match_fragment(plan)
        if frag is None:
            return None
        spec, build, probe = frag
        # the fragment's dominant linear intermediate is the join hash
        # table; quoting with it makes the pressure signal (grant size AND
        # expected admission wait) the same answer the join's grant
        # acquisition would get
        mem_q, dev_q, rsv = self._quotes(
            self.selector.model.hash_need_bytes(len(build)),
            lanes=self.max_shards)
        try:
            decision = self.selector.choose_fragment(
                spec, build, probe, mem_quote=mem_q, dev_quote=dev_q,
                max_shards=self.max_shards)
            if decision.path != "tensor":
                return None  # generic walk re-quotes (and re-reserves) itself
            decisions.append(decision)
            frag_guard = None
            if self.guards:
                from .guards import ExecutionGuard

                # fragment guard: observes the fused program's capacity
                # overflows (actual join fan-out vs. the optimistic bucket)
                # and can abandon the retry loop when the re-priced linear
                # fragment beats re-running at the exact bucket
                frag_guard = ExecutionGuard(
                    self.selector.model, op="fused_pipeline",
                    t_linear=max(0.0,
                                 decision.t_linear - decision.mem_wait_s),
                    t_tensor=decision.t_tensor, predicted_spill_bytes=0,
                    rows_in=len(build) + len(probe))
            t_pre = time.perf_counter()
            try:
                result, m = run_fused(spec, build, probe,
                                      decision_reason=decision.reason,
                                      broker=self.broker,
                                      shards=decision.shards,
                                      guard=frag_guard, device=self.device)
            except TransientError:
                # an injected/real infrastructure fault is NOT a fallback
                # case: it must reach the retry loop (and the device-failure
                # counter), not silently reroute onto the generic walk
                decisions.pop()
                raise
            except SwitchPoint as sp:
                # the fragment guard reversed the decision on observed
                # fan-out: hand the plan to the generic walk, which
                # re-quotes with its own (now wiser) decisions; the
                # abandoned wall is stamped after the walk completes
                decisions.pop()
                self._tls.fragment_switch = (time.perf_counter() - t_pre,
                                             sp.reason)
                self.broker.note_switch()
                return None
            except PredicateError:
                # a predicate that cannot run on device tensors (np.nonzero
                # & friends): fall back to the generic walk, which evaluates
                # it on host.  Nothing else falls back: a kernel that fails
                # to launch, a CUDA error or a wrong result must surface
                # here, not hide behind a quiet re-run on another path.
                decisions.pop()
                return None
        finally:
            if rsv is not None:
                rsv.cancel()  # fused runs on device; the memory hold lapses
        m.decision_reason = decision.reason
        metrics.append(m)
        # Feedback hygiene: a cold run (a new program's first call) is not a
        # steady-state observation — recording its wall would poison the
        # profile and flip the very next decision back to linear.  Only
        # warm (cache-hitting) runs feed the loop.  The per-run `compiled`
        # flag, not a global counter delta: another thread's concurrent
        # cold run must not make THIS warm run look cold.
        if not m.compiled:
            self._record_profile(metrics, verified_warm=True)
            prof = getattr(self.selector, "profile", None)
            if prof is not None:
                # sharded runs feed their own profile cell: the two fused
                # programs have different cost structures, and blending
                # them would drag each estimate toward the other's regime
                frag_path = "tensor_sharded" if m.devices > 1 else "tensor"
                prof.record("fragment", frag_path, len(build) + len(probe),
                            m.wall_s - m.queue_wait_s)
        if isinstance(result, Relation):
            return QueryResult(result, None, metrics, decisions)
        return QueryResult(None, float(result), metrics, decisions)

    # -- root materialization ----------------------------------------------
    def _materialize_root(self, out, metrics):
        """The single host-materialization point of a device-resident query.

        This is where the per-operator tensor path's LAZY device work
        actually executes (pending gathers + the result fetch), so it — not
        just the operator launch sites — runs under a device lease: without
        it, concurrent materializations would time-slice against each other
        and their walls would carry exactly the contention noise the
        ROADMAP flagged for profile feedback.
        """
        if isinstance(out, DeviceRelation):
            sig = ("materialize", out.num_physical_rows, out.names,
                   out.valid is None)
            with self._device_leased(sig) as lease:
                with Timer() as t:
                    rel = out.to_host()
            m = OpMetrics(
                op="materialize", path="tensor", rows_in=len(out),
                rows_out=len(rel), wall_s=t.elapsed, spill=SpillAccount(),
                host_syncs=1)
            self._stamp_lease(m, lease)
            metrics.append(m)
            return rel
        if isinstance(out, _DeviceScalar):
            # 0-d device scalar from an Aggregate over a device relation;
            # one fetch brings the value and its supporting row count
            with self._device_leased(("agg_fetch", out.fn)) as lease:
                with Timer() as t:
                    val, n_valid = (float(x) for x in
                                    to_host([out.value, out.n_valid]))
            m = OpMetrics(
                op="materialize", path="tensor", rows_in=1, rows_out=1,
                wall_s=t.elapsed, spill=SpillAccount(), host_syncs=1)
            self._stamp_lease(m, lease)
            metrics.append(m)
            if out.fn in ("min", "max") and n_valid == 0:
                raise ValueError(
                    f"{out.fn} over an empty result has no identity")
            return val
        return out

    @staticmethod
    def _lower_for_linear(*rels):
        """Lower device relations for a linear-path operator (regime
        crossing).  Returns the host relations plus the number of
        device→host transfers performed, which the caller charges to the
        operator that demanded the lowering."""
        out = []
        syncs = 0
        for rel in rels:
            if isinstance(rel, DeviceRelation):
                rel = rel.to_host()
                syncs += 1
            out.append(rel)
        return (*out, syncs)

    def _to_device(self, rel):
        """Device residency for a tensor-path operator input.  Host base
        tables go through the device column cache (exact shapes), so
        repeated queries pay zero re-upload; packed layouts
        (core/codec_device) upload narrow codes and defer the decode to
        first consumption.  Returns the relation plus the PHYSICAL H2D
        bytes this call transferred and the same transfer priced at
        logical width, which the caller charges to the operator that
        demanded the transfer."""
        if isinstance(rel, DeviceRelation):
            return rel, 0, 0
        from .table_cache import get_device_layouts

        cols, uploaded, logical = get_device_layouts(rel, bucket=None,
                                                     device=self.device)
        return DeviceRelation.from_codes(cols), uploaded, logical

    # -- node dispatch -----------------------------------------------------
    def _exec(self, node, metrics, decisions, mgr):
        if isinstance(node, Scan):
            return node.relation
        if isinstance(node, Project):
            child = self._exec(node.child, metrics, decisions, mgr)
            if not isinstance(child, (Relation, DeviceRelation)):
                raise TypeError(
                    "Project over a scalar-producing child (Aggregate) is "
                    "not a valid plan shape")
            # structural on both regimes: Relation.select slices the column
            # dict, DeviceRelation.select keeps lazy gathers pending
            return child.select(list(node.columns))
        if isinstance(node, Filter):
            child = self._exec(node.child, metrics, decisions, mgr)
            if isinstance(child, DeviceRelation):
                from .fused import PredicateError, device_mask

                try:
                    mask = device_mask(node.predicate, child,
                                       child.num_physical_rows, child.device)
                    return child.mask_and(mask)
                except PredicateError:
                    # predicate needs host numpy: a real regime crossing,
                    # accounted against this operator
                    n_in = len(child)
                    with Timer() as t:
                        child = child.to_host()
                    metrics.append(OpMetrics(
                        op="filter_materialize", path="tensor",
                        rows_in=n_in, rows_out=len(child), wall_s=t.elapsed,
                        spill=SpillAccount(), host_syncs=1))
            mask = node.predicate(child)
            return child.take(np.nonzero(mask)[0])
        if isinstance(node, Join):
            build = self._exec(node.build, metrics, decisions, mgr)
            probe = self._exec(node.probe, metrics, decisions, mgr)
            mem_q, dev_q, rsv = self._quotes(
                self.selector.model.hash_need_bytes(len(build)))

            def join_tensor():
                dev_b, up_b, log_b = self._to_device(build)
                dev_p, up_p, log_p = self._to_device(probe)
                sig = ("join", dev_b.num_physical_rows,
                       dev_p.num_physical_rows, node.key)
                with self._device_leased(sig) as lease:
                    out, m = tensor_join_device(
                        dev_b, dev_p, node.key,
                        dense=dense_join_domain(build, node.key))
                self._stamp_lease(m, lease)
                m.h2d_bytes += up_b + up_p
                m.h2d_bytes_logical += log_b + log_p
                return out, m

            try:
                decision = self._decide(self.selector.choose_join(
                    build, probe, node.key, mem_quote=mem_q, dev_quote=dev_q))
                decisions.append(decision)
                if decision.path == "tensor":
                    out, m = join_tensor()
                else:
                    hb, hp, syncs = self._lower_for_linear(build, probe)
                    pre_path = "linear_tiered" if decision.tiered else "linear"
                    t_pre = time.perf_counter()
                    try:
                        with self._granted(
                                self.selector.model.hash_need_bytes(len(hb)),
                                reservation=rsv) as (wm, grant):
                            self._apply_tier_quota(mgr, grant)
                            token = self._preempt_token(grant)
                            guard = self._guard(decision, "hash_join",
                                                len(hb) + len(hp), token)
                            try:
                                out, m = hash_join_linear(
                                    hb, hp, node.key, wm, mgr, cancel=guard)
                            finally:
                                self._drop_token(token)
                        m.host_syncs += syncs
                        self._stamp_grant(m, grant)
                    except PreemptedError:
                        # the broker cancelled this floor-degraded spill:
                        # requeue on the tensor path (the grant is already
                        # released by the _granted exit).  The abandoned
                        # attempt's wall is kept under pre_switch_* so
                        # end-to-end accounting stays honest without
                        # polluting the tensor profile cell.
                        pre_wall = time.perf_counter() - t_pre
                        out, m = join_tensor()
                        m.preempted = True
                        m.wall_s += pre_wall
                        m.pre_switch_wall_s = pre_wall
                        m.pre_switch_path = pre_path
                    except SwitchPoint as sp:
                        # the guard reversed the decision mid-spill: finish
                        # on the tensor path, reusing the already-spilled
                        # partitions (the grant is released; mgr is alive)
                        if sp.restart:
                            # fired mid-partition-pass: no reusable prefix
                            # yet — drop the partial spill files (keeping
                            # the books balanced) and re-run the whole
                            # join from the base relations, which hit the
                            # device column cache
                            spill = sp.spill if sp.spill is not None \
                                else SpillAccount()
                            for p in sp.pending:
                                if p:
                                    mgr.delete(p, spill)
                            out, m = join_tensor()
                            m.spill = spill
                            self._stamp_switch(m, sp, pre_path)
                            self.broker.note_switch()
                        else:
                            out, m = self._complete_join_switch(
                                sp, node.key, mgr, len(hb) + len(hp),
                                pre_path)
                        m.host_syncs += syncs
            finally:
                if rsv is not None:
                    rsv.cancel()  # idempotent; no-op after conversion
            if not m.switched:
                m.decision_reason = decision.reason
            metrics.append(m)
            return out
        if isinstance(node, Sort):
            child = self._exec(node.child, metrics, decisions, mgr)
            mem_q, dev_q, rsv = self._quotes(
                self.selector.model.sort_need_bytes(
                    len(child), child.row_bytes()))

            def sort_tensor():
                dev_c, up_c, log_c = self._to_device(child)
                sig = ("sort", dev_c.num_physical_rows, tuple(node.keys),
                       dev_c.valid is None)
                with self._device_leased(sig) as lease:
                    out, m = tensor_sort_device(dev_c, node.keys)
                self._stamp_lease(m, lease)
                m.h2d_bytes += up_c
                m.h2d_bytes_logical += log_c
                return out, m

            try:
                decision = self._decide(self.selector.choose_sort(
                    child, node.keys, mem_quote=mem_q, dev_quote=dev_q))
                decisions.append(decision)
                if decision.path == "tensor":
                    out, m = sort_tensor()
                else:
                    hc, syncs = self._lower_for_linear(child)
                    pre_path = "linear_tiered" if decision.tiered else "linear"
                    t_pre = time.perf_counter()
                    try:
                        with self._granted(
                                self.selector.model.sort_need_bytes(
                                    len(hc), hc.row_bytes()),
                                reservation=rsv) as (wm, grant):
                            self._apply_tier_quota(mgr, grant)
                            token = self._preempt_token(grant)
                            guard = self._guard(decision, "sort", len(hc),
                                                token)
                            try:
                                out, m = sort_linear(hc, node.keys, wm, mgr,
                                                     cancel=guard)
                            finally:
                                self._drop_token(token)
                        m.host_syncs += syncs
                        self._stamp_grant(m, grant)
                    except PreemptedError:
                        pre_wall = time.perf_counter() - t_pre
                        out, m = sort_tensor()
                        m.preempted = True
                        m.wall_s += pre_wall
                        m.pre_switch_wall_s = pre_wall
                        m.pre_switch_path = pre_path
                    except SwitchPoint as sp:
                        # sort has no cross-path partial order to reuse:
                        # drop the abandoned runs (balancing the spill
                        # books) and re-run from the base relation on device
                        spill = sp.spill if sp.spill is not None \
                            else SpillAccount()
                        for p in sp.pending:
                            if p:
                                mgr.delete(p, spill)
                        out, m = sort_tensor()
                        m.spill = spill
                        self._stamp_switch(m, sp, pre_path)
                        self.broker.note_switch()
            finally:
                if rsv is not None:
                    rsv.cancel()
            if not m.switched:
                m.decision_reason = decision.reason
            metrics.append(m)
            return out
        if isinstance(node, GroupBy):
            child = self._exec(node.child, metrics, decisions, mgr)
            from .aggregate import group_aggregate_device, group_aggregate_linear
            # GROUP BY is the third linearizing operator: the group hash
            # table is the linearized intermediate; selection mirrors sort
            # the probe uses the same unit estimate_sort's fits-check
            # compares (data bytes), not the group-table estimate the
            # grant below requests — mixing units would price a spill an
            # ungoverned session with the same work_mem would never see
            mem_q, dev_q, rsv = self._quotes(
                self.selector.model.sort_need_bytes(
                    len(child), child.row_bytes()))
            try:
                decision = self._decide(self.selector.choose_sort(
                    child, [node.key], mem_quote=mem_q, dev_quote=dev_q))
                decisions.append(decision)
                if decision.path == "tensor":
                    dev_c, up_c, log_c = self._to_device(child)
                    sig = ("group", dev_c.num_physical_rows,
                           tuple(node.values.items()), dev_c.valid is None)
                    with self._device_leased(sig) as lease:
                        out, m = group_aggregate_device(dev_c, node.key,
                                                        node.values)
                    self._stamp_lease(m, lease)
                    m.h2d_bytes += up_c
                    m.h2d_bytes_logical += log_c
                else:
                    child, syncs = self._lower_for_linear(child)
                    # grant sized by estimated DISTINCT groups (the group
                    # hash table's real footprint), via the cached key
                    # sketch — a low-cardinality aggregate over many rows
                    # must not hold a work_mem-sized slice of the shared
                    # budget it cannot use
                    from .table_cache import key_stats

                    st = key_stats(child, node.key)
                    scale = max(1, len(child) // max(1, st.sample_n))
                    n_groups = min(len(child), max(1, st.card * scale))
                    with self._granted(self.selector.model.hash_need_bytes(
                            n_groups), reservation=rsv) as (wm, grant):
                        self._apply_tier_quota(mgr, grant)
                        out, m = group_aggregate_linear(child, node.key,
                                                        node.values, wm, mgr)
                    m.host_syncs += syncs
                    self._stamp_grant(m, grant)
            finally:
                if rsv is not None:
                    rsv.cancel()
            m.decision_reason = decision.reason
            metrics.append(m)
            return out
        if isinstance(node, Aggregate):
            child = self._exec(node.child, metrics, decisions, mgr)
            if isinstance(child, DeviceRelation):
                return _device_aggregate(child, node.column, node.fn)
            col = child[node.column]
            if node.fn == "sum":
                return float(col.sum())
            if node.fn == "count":
                return float(len(col))
            if node.fn == "min":
                return float(col.min())
            if node.fn == "max":
                return float(col.max())
            raise ValueError(node.fn)
        raise TypeError(f"unknown plan node {node!r}")


@dataclasses.dataclass
class _DeviceScalar:
    """A deferred aggregate: the 0-d device value plus the valid-row count
    backing it (min/max over zero rows has no identity and must error at
    materialization, matching the host path's numpy reduction)."""
    value: object
    n_valid: object
    fn: str


def _device_aggregate(rel: DeviceRelation, column: str, fn: str) -> _DeviceScalar:
    """Masked scalar reduction on device; the root fetches the 0-d result."""
    from .fused import _fill_max, _fill_min

    col = rel.col(column)
    valid = rel.valid
    n_valid = (torch.tensor(col.shape[0], dtype=torch.int64)
               if valid is None else valid.sum())
    if fn == "sum":
        if valid is None:
            out = col.sum()
        else:
            out = torch.where(valid, col, torch.zeros((), dtype=col.dtype,
                                                      device=col.device)).sum()
    elif fn == "count":
        out = n_valid
    elif fn == "min":
        out = (col if valid is None
               else torch.where(valid, col, _fill_max(col.dtype))).min()
    elif fn == "max":
        out = (col if valid is None
               else torch.where(valid, col, _fill_min(col.dtype))).max()
    else:
        raise ValueError(fn)
    return _DeviceScalar(out, n_valid.to(col.device), fn)
