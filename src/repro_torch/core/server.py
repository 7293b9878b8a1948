"""Concurrent serving layer: closed-loop and open-loop query streams.

The port of ``src/repro/core/server.py``.  The server hands ``device`` to
its :class:`~repro_torch.core.session.Session`: tensor-path work runs on
the CUDA card unless the caller passes ``device="cpu"``, and without a card
the constructor raises.  Every worker thread launches on its thread's
current (default) stream.  ``max_shards > 1`` serves sharded fragments over
that many logical lanes (at most
:func:`~repro_torch.distributed.sharding.available_partitions`), their
partitions placed on the session's devices (every visible card for
``device="cuda"``).

This is the repo's traffic model for the paper's headline claim.  Single-query
benchmarks (fig1–fig10) measure *throughput* per path; the phase transition
the paper actually reports — linear-path P99 going multi-second under
``work_mem`` pressure while the tensor path stays sub-second — only exists
when **concurrent queries contend for one memory pool**.  A
:class:`QueryServer` provides exactly that:

  * one :class:`~repro_torch.core.session.Session` shared by every worker
    (shared device column cache, compiled-program cache, runtime profile — the
    serving configuration);
  * one :class:`~repro_torch.core.memory_governor.MemoryGovernor` owning the total
    memory budget; every linear operator runs under a grant, so N concurrent
    linear queries genuinely squeeze each other into the spill regime;
  * two load generators:

      - :meth:`QueryServer.serve` — **closed loop**: each of N workers
        submits its next query the moment the previous one completes, so
        offered concurrency is exactly N (the fig11/fig12 configuration);
      - :meth:`QueryServer.serve_open` — **open loop**: an
        :class:`~repro_torch.core.slo.ArrivalProcess` schedules thousands of
        logical clients on their own clock (Poisson / bursty phases), a
        bounded worker pool drains a priority queue, and per-tenant
        :class:`~repro_torch.core.slo.TenantClass` deadlines drive **admission
        shedding** (a sheddable query whose quoted wait already exceeds its
        deadline is rejected up front), **deadline enforcement** (an
        admitted query that starves past its deadline in queue is recorded
        as failed, not silently served late), and **preemption** (a
        positive-priority tenant facing blocked admission cancels
        floor-degraded linear operators mid-spill; they re-run on the
        tensor path).  This is the fig13 configuration — a closed loop
        cannot even *express* the overload it measures, because a closed
        loop's offered load politely throttles itself (the classic
        coordinated-omission trap).

Failure discipline (both loops): every submitted query ends as exactly one
of **served**, **shed**, or **failed**.  Per-query exceptions — injected
faults that exhausted their retries, deadline misses, anything raised by
the engine — become :class:`FailedQuery` records, and the run keeps going.
Only a :class:`~repro_torch.core.memory_governor.BrokerInvariantViolation` (the
never-over-budget invariant itself broke — the one condition that poisons
every subsequent measurement) aborts the run and re-raises.

:meth:`QueryServer.serve` and :meth:`~QueryServer.serve_open` return a
:class:`ServeReport` with the full latency sample set, P50/P99, per-query
spill volume and grant sizes, shed/failed partitions, per-tenant SLO
attainment, fault-injection counts, and the governor's invariant counters
(``over_budget_events`` must be 0).

    >>> server = QueryServer({"orders": orders, "users": users},
    ...                      total_mem=64 * MB, work_mem=32 * MB,
    ...                      device="cuda")
    >>> q = server.session.table("orders").join("users", on="uid") \\
    ...           .sort("uid").aggregate("w", "sum")
    >>> report = server.serve([q], concurrency=8, queries_per_worker=4)
    >>> report.latency.p99, report.governor.over_budget_events
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence

from .executor import QueryResult
from .faults import FaultInjector, SimulatedCrash
from .memory_governor import (BrokerInvariantViolation, GovernorStats,
                              MemoryGovernor)
from .metrics import LatencyStats, Timer, latency_stats
from .relation import Relation
from .resource_broker import (BrokerStats, DeviceQueue, ResourceBroker,
                              ResourceRequest)
from .session import Session
from .slo import ArrivalProcess, TenantClass
from .tier import TierConfig

__all__ = ["QueryServer", "ServeReport", "ServedQuery", "ShedQuery",
           "FailedQuery"]

MB = 1 << 20


@dataclasses.dataclass
class ServedQuery:
    """One completed query of a serving run."""

    worker: int
    seq: int               # per-worker sequence number (closed loop) or
                           # global submission sequence (open loop)
    workload_idx: int      # which workload item this was
    wall_s: float          # end-to-end latency; open loop: arrival→done
                           # sojourn incl. queueing (no coordinated omission)
    temp_mb: float         # temp-file bytes this query spilled
    grant_bytes: int       # smallest grant any of its linear operators got
    paths: str             # "tensor", "linear", or "mixed"
    scalar: Optional[float]
    relation: Optional[Relation]
    mem_wait_s: float = 0.0    # total memory-admission wait across operators
    queue_wait_s: float = 0.0  # total device-lease wait across operators
    batched: bool = False      # any dispatch ran in a coalesced lease group
    tenant: str = ""           # open loop: the TenantClass this ran under
    arrival_s: float = 0.0     # open loop: arrival offset from run start
    service_s: float = 0.0     # open loop: execution time excl. queueing
    slo_ok: bool = True        # open loop: sojourn <= tenant deadline
    preempted: bool = False    # any operator was preempted → tensor re-run
    switched: bool = False     # any operator took a guard SwitchPoint:
                               # abandoned its mispriced path mid-query and
                               # finished on the tensor path (partition reuse)
    h2d_bytes: int = 0         # PHYSICAL host→device bytes (packed codes +
                               # dictionaries under compressed layouts; 0
                               # when every input was device-resident)
    h2d_bytes_logical: int = 0  # same transfers at logical column width —
                               # physical/logical is the query's effective
                               # H2D compression ratio


@dataclasses.dataclass
class ShedQuery:
    """One query rejected by admission control (load shedding): its quoted
    wait already exceeded its deadline, so serving it would have burned
    capacity on a result nobody could use."""

    tenant: str
    seq: int               # global submission sequence
    workload_idx: int
    arrival_s: float       # arrival offset from run start
    quoted_wait_s: float   # the wait admission quoted at arrival
    deadline_s: float      # the tenant deadline it exceeded


@dataclasses.dataclass
class FailedQuery:
    """One query that was admitted but did not produce a result: a typed
    engine error that survived retries, or a deadline miss while queued.
    ``error`` is the exception class name (``"DeadlineExceeded"``,
    ``"SpillIOError"``, ...)."""

    worker: int
    seq: int
    workload_idx: int
    error: str
    message: str = ""
    tenant: str = ""
    arrival_s: float = 0.0
    wall_s: float = 0.0    # arrival→failure (open loop) or submit→raise


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one :meth:`QueryServer.serve` /
    :meth:`QueryServer.serve_open` run."""

    queries: List[ServedQuery]
    latency: LatencyStats
    wall_s: float                  # whole-run wall time
    total_temp_mb: float
    governor: GovernorStats
    concurrency: int
    # per-run broker accounting (device dispatch groups/coalescing, lease
    # waits, quote counts, reservations, preemptions); EWMA/peak fields are
    # end-of-run gauges
    broker: Optional[BrokerStats] = None
    shed: List[ShedQuery] = dataclasses.field(default_factory=list)
    failed: List[FailedQuery] = dataclasses.field(default_factory=list)
    submitted: int = 0             # every arrival: served + shed + failed
    # fault-injection counts for THIS run (None when no injector): the chaos
    # gate asserts these are nonzero, so "survived chaos" can never mean
    # "chaos never happened"
    faults: Optional[Dict[str, int]] = None
    # spill-tier ledger snapshot (None when the session spills straight to
    # disk): per tier {bytes_written, bytes_read, bytes_freed, live_bytes,
    # ...} plus pool_leaked_bytes / prefetches / managers — cumulative over
    # the server's session lifetime, because the balance invariant
    # (freed == written, live == 0, zero pool leak) is only meaningful at
    # quiesce over ALL managers, warmup included
    tiers: Optional[Dict[str, object]] = None

    @property
    def qps(self) -> float:
        return len(self.queries) / max(self.wall_s, 1e-9)

    @property
    def p99_over_p50(self) -> float:
        """The paper's stability metric: tail amplification of the latency
        distribution.  ~1 = predictable; >>1 = the spill-regime tail."""
        return self.latency.p99 / max(self.latency.p50, 1e-9)

    @property
    def total_h2d_bytes(self) -> int:
        """Physical host→device bytes across all served queries (warm
        serving over device-resident tables reports 0)."""
        return sum(q.h2d_bytes for q in self.queries)

    @property
    def total_h2d_bytes_logical(self) -> int:
        """The same transfers priced at logical column width; the run-level
        ratio physical/logical is what fig17's cold cells gate on."""
        return sum(q.h2d_bytes_logical for q in self.queries)

    @property
    def counts(self) -> Dict[str, int]:
        return {"submitted": self.submitted, "served": len(self.queries),
                "shed": len(self.shed), "failed": len(self.failed)}

    def by_workload(self, idx: int) -> List[ServedQuery]:
        return [q for q in self.queries if q.workload_idx == idx]

    # -- per-tenant views (open-loop runs) -----------------------------------
    def tenant_queries(self, tenant: str) -> List[ServedQuery]:
        return [q for q in self.queries if q.tenant == tenant]

    def tenant_latency(self, tenant: str) -> Optional[LatencyStats]:
        """Sojourn-latency stats for one tenant's served queries (None when
        it served nothing)."""
        samples = [q.wall_s for q in self.tenant_queries(tenant)]
        return latency_stats(samples) if samples else None

    def tenant_counts(self, tenant: str) -> Dict[str, int]:
        served = len(self.tenant_queries(tenant))
        shed = sum(1 for s in self.shed if s.tenant == tenant)
        failed = sum(1 for f in self.failed if f.tenant == tenant)
        return {"submitted": served + shed + failed, "served": served,
                "shed": shed, "failed": failed}

    def slo_attainment(self, tenant: str) -> float:
        """Fraction of this tenant's *served* queries that met their
        deadline (1.0 when it served nothing — no evidence of a miss)."""
        qs = self.tenant_queries(tenant)
        if not qs:
            return 1.0
        return sum(1 for q in qs if q.slo_ok) / len(qs)


def _min_grant_of(result: QueryResult) -> int:
    grants = [m.grant_bytes for m in result.metrics if m.grant_bytes > 0]
    return min(grants) if grants else 0


def _paths_of(result: QueryResult) -> str:
    paths = {d.path for d in result.decisions}
    if len(paths) == 1:
        return next(iter(paths))
    return "mixed" if paths else "none"


class QueryServer:
    """Owns the serving-scope state: session + tables + resource broker.

    ``total_mem`` is the budget EVERY concurrent linear operator shares;
    ``work_mem`` is the per-operator ceiling a single grant may reach (the
    classic PostgreSQL meaning).  ``total_mem=None`` runs ungoverned —
    every query gets the full ``work_mem``, which reduces to the
    single-query semantics of the earlier PRs.

    Every server owns its :class:`~repro_torch.core.resource_broker.
    ResourceBroker` (private device queue + the governor): leases, queue
    depth, EWMA waits and pressure quotes are all per-server state, so one
    server's load never pollutes another's pricing.  That isolation trades
    away cross-server device serialization — servers meant to run
    CONCURRENTLY in one process should share a queue (build their sessions
    over brokers constructed with the same
    :class:`~repro_torch.core.resource_broker.DeviceQueue`).  ``grant_policy``
    selects the governor's degradation policy (``"floor"`` default,
    ``"proportional"`` for the PG hash_mem_multiplier analogue, or a
    :class:`~repro_torch.core.memory_governor.GrantPolicy` instance);
    ``queue_aware=False`` disables the broker's wait pricing — the
    queue-blind ablation fig12 measures against (grant sizing stays
    pressure-aware; only the wait terms vanish); ``device_max_batch``
    bounds a coalesced device-dispatch group (``1`` = strict PR-4
    one-at-a-time serialization, ``None`` = unbounded coalescing);
    ``reservations=False`` is the quote-only ablation — ``auto`` prices
    against non-binding quotes and fig13 counts the decide-then-lose
    incidents; ``faults`` plugs a :class:`~repro_torch.core.faults.FaultInjector`
    into every fault site the serving path crosses (spill writes and reads,
    device dispatch, memory grants) for chaos runs; ``tiers`` (a
    :class:`~repro_torch.core.tier.TierConfig`, or ``True`` for the defaults)
    routes every spill through the T0/T1/T2 hierarchy, makes grants
    tiered, and adds the session-lifetime per-tier books to the report
    (``report.tiers``); ``device`` is the session's device (the CUDA card
    unless ``"cpu"``).
    """

    def __init__(self, tables: Dict[str, Relation],
                 total_mem: Optional[int], work_mem: Optional[int] = None,
                 policy: Optional[str] = None,
                 min_grant: Optional[int] = None,
                 full_grant_wait_s: Optional[float] = None,
                 grant_policy=None,
                 queue_aware: Optional[bool] = None,
                 device_max_batch: Optional[int] = None,
                 reservations: Optional[bool] = None,
                 faults: Optional[FaultInjector] = None,
                 retry=None,
                 max_shards: Optional[int] = None,
                 tiers: Optional[TierConfig] = None,
                 guards: Optional[bool] = None,
                 session: Optional[Session] = None,
                 device=None):
        if session is not None:
            # a prebuilt session owns its broker, governor, work_mem and
            # policy; silently dropping overrides would let a caller
            # believe it forced a configuration it never got
            conflicts = {"total_mem": total_mem, "work_mem": work_mem,
                         "policy": policy, "min_grant": min_grant,
                         "full_grant_wait_s": full_grant_wait_s,
                         "grant_policy": grant_policy,
                         "queue_aware": queue_aware,
                         "device_max_batch": device_max_batch,
                         "reservations": reservations,
                         "faults": faults, "retry": retry,
                         "max_shards": max_shards, "tiers": tiers,
                         "guards": guards, "device": device}
            given = [k for k, v in conflicts.items() if v is not None]
            if given:
                raise ValueError(
                    f"pass either a prebuilt session or "
                    f"{'/'.join(given)}; an explicit session already owns "
                    f"its broker, governor, work_mem and policy")
        else:
            # one TierConfig instance shared by governor (tiered grants +
            # quote pricing), selector (staircase candidate) and executor
            # (per-query TierManager construction)
            if tiers is True:
                tiers = TierConfig()
            governor = (MemoryGovernor(
                total_mem,
                min_grant=1 * MB if min_grant is None else min_grant,
                full_grant_wait_s=full_grant_wait_s or 0.0,
                policy=grant_policy, tiers=tiers)
                if total_mem is not None else None)
            broker = ResourceBroker(
                governor,
                device_queue=DeviceQueue(max_group=device_max_batch),
                queue_pricing=True if queue_aware is None else queue_aware,
                reservations=True if reservations is None else reservations,
                faults=faults)
            session = Session(
                work_mem=32 * MB if work_mem is None else work_mem,
                policy=policy or "auto", broker=broker, retry=retry,
                max_shards=1 if max_shards is None else max_shards,
                tiers=tiers,
                guards=True if guards is None else guards,
                device="cuda" if device is None else device)
        self.session = session
        self.governor = session.governor
        self.broker = session.broker
        # Sharded serving: pre-create the broker's device lanes at build
        # time (capped at the logical lanes available), so admission quotes
        # see per-lane waits from the first arrival instead of only after
        # the first gang dispatch lazily grew the lane set.
        if self.session.executor.max_shards > 1:
            from ..distributed.sharding import available_partitions

            self.broker.ensure_lanes(
                min(self.session.executor.max_shards,
                    available_partitions()))
        self.faults = session.executor.faults
        for name, rel in tables.items():
            self.session.register(name, rel)

    # -- single query --------------------------------------------------------
    def submit(self, query) -> QueryResult:
        """Run one query through the governed session (any :class:`Query`,
        logical tree, or legacy physical tree)."""
        return self.session.execute(query)

    # -- report assembly -----------------------------------------------------
    def _snapshot_base(self):
        gov = (self.governor.stats() if self.governor is not None
               else GovernorStats())
        fts = self.faults.counts() if self.faults is not None else None
        return gov, self.broker.stats(), fts

    def _build_report(self, base, served, shed, failed, submitted, wall_s,
                      concurrency) -> ServeReport:
        base_gov, base_broker, base_faults = base
        gov = (self.governor.stats() if self.governor is not None
               else GovernorStats())
        # report the governor's activity for THIS run (counters are
        # cumulative; peak and invariant counters are monotone so the
        # absolute values remain the right thing to assert on)
        gov.grants -= base_gov.grants
        gov.degraded -= base_gov.degraded
        gov.waits -= base_gov.waits
        gov.wait_s_total -= base_gov.wait_s_total
        gov.holds -= base_gov.holds
        gov.holds_converted -= base_gov.holds_converted
        gov.holds_expired -= base_gov.holds_expired
        gov.holds_cancelled -= base_gov.holds_cancelled
        fault_counts = None
        if self.faults is not None:
            now = self.faults.counts()
            fault_counts = {k: now[k] - (base_faults or {}).get(k, 0)
                            for k in now}
        return ServeReport(
            queries=served,
            latency=(latency_stats([q.wall_s for q in served]) if served
                     else LatencyStats(0.0, 0.0, 0.0, 0.0, 0.0, 0)),
            wall_s=wall_s,
            total_temp_mb=sum(q.temp_mb for q in served),
            governor=gov,
            concurrency=concurrency,
            broker=self.broker.stats().since(base_broker),
            shed=shed, failed=failed, submitted=submitted,
            faults=fault_counts,
            tiers=(self.session.tier_ledger.snapshot()
                   if getattr(self.session, "tier_ledger", None) is not None
                   else None))

    def _served_record(self, res: QueryResult, *, worker: int, seq: int,
                       idx: int, wall_s: float, keep: bool,
                       tenant: str = "", arrival_s: float = 0.0,
                       service_s: float = 0.0,
                       slo_ok: bool = True) -> ServedQuery:
        return ServedQuery(
            worker=worker, seq=seq, workload_idx=idx,
            wall_s=wall_s, temp_mb=res.total_temp_mb,
            grant_bytes=_min_grant_of(res),
            paths=_paths_of(res), scalar=res.scalar,
            relation=res.relation if keep else None,
            mem_wait_s=sum(m.mem_wait_s for m in res.metrics),
            queue_wait_s=sum(m.queue_wait_s for m in res.metrics),
            batched=any(m.batched for m in res.metrics),
            tenant=tenant, arrival_s=arrival_s,
            service_s=service_s or wall_s, slo_ok=slo_ok,
            preempted=any(m.preempted for m in res.metrics),
            switched=any(m.switched for m in res.metrics),
            h2d_bytes=res.total_h2d_bytes,
            h2d_bytes_logical=res.total_h2d_bytes_logical)

    # -- closed-loop stream --------------------------------------------------
    def serve(self, workload: Sequence, concurrency: int,
              queries_per_worker: int, warmup: int = 1,
              keep_relations: bool = True) -> ServeReport:
        """Drive ``concurrency`` workers in a closed loop.

        Each worker executes ``queries_per_worker`` queries back-to-back,
        cycling through ``workload`` (Query objects or logical/physical
        trees) at a per-worker offset so every item sees traffic from
        several workers.  ``warmup`` serial passes over the workload run
        first, off the clock — they converge the compile cache, the device
        column cache and the runtime profile, so the measured window
        reflects steady-state serving, not first-query compilation.

        ``keep_relations=False`` drops each relation-rooted result after
        recording its size — a long measurement run otherwise pins every
        result relation in memory until the report is dropped, making the
        harness itself the dominant memory consumer while it measures
        memory-pressure behavior.

        A query that raises is recorded as a :class:`FailedQuery` sample and
        the run continues — under fault injection, a failed query is data,
        not a reason to discard the measurement.  Only a
        :class:`~repro_torch.core.memory_governor.BrokerInvariantViolation`
        aborts the run and re-raises: the budget invariant breaking poisons
        every subsequent sample.
        """
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if queries_per_worker < 1:
            raise ValueError(f"queries_per_worker must be >= 1, got "
                             f"{queries_per_worker}")
        workload = list(workload)
        if not workload:
            raise ValueError("empty workload")
        for _ in range(max(0, warmup)):
            for item in workload:
                self.submit(item)

        base = self._snapshot_base()
        served: List[ServedQuery] = []
        failed: List[FailedQuery] = []
        errors: List[BaseException] = []
        lock = threading.Lock()

        def worker(wid: int) -> None:
            for seq in range(queries_per_worker):
                idx = (wid + seq) % len(workload)
                t = Timer()
                try:
                    with t:
                        res = self.submit(workload[idx])
                except BrokerInvariantViolation as e:
                    with lock:  # the one non-survivable failure
                        errors.append(e)
                    return
                except (Exception, SimulatedCrash) as e:
                    with lock:
                        failed.append(FailedQuery(
                            worker=wid, seq=seq, workload_idx=idx,
                            error=type(e).__name__, message=str(e),
                            wall_s=t.elapsed))
                    continue
                except BaseException as e:  # KeyboardInterrupt etc.
                    with lock:
                        errors.append(e)
                    return
                rec = self._served_record(res, worker=wid, seq=seq, idx=idx,
                                          wall_s=t.elapsed,
                                          keep=keep_relations)
                with lock:
                    served.append(rec)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(concurrency)]
        with Timer() as run_t:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        if errors:
            raise errors[0]

        return self._build_report(
            base, served, [], failed,
            submitted=len(served) + len(failed),
            wall_s=run_t.elapsed, concurrency=concurrency)

    # -- open-loop stream ----------------------------------------------------
    def serve_open(self, workloads: Mapping[str, Sequence],
                   arrivals: Mapping[str, ArrivalProcess],
                   duration_s: float, tenants: Sequence[TenantClass],
                   workers: int = 4, warmup: int = 1,
                   shed: bool = True, preempt: bool = True,
                   keep_relations: bool = False) -> ServeReport:
        """Open-loop SLO-aware serving: the fig13 load.

        ``workloads`` maps tenant name → query sequence; ``arrivals`` maps
        tenant name → :class:`~repro_torch.core.slo.ArrivalProcess` (each arrival
        is an independent logical client — a storm of thousands of arrivals
        models thousands of clients without thousands of threads); both key
        sets must exactly match the names in ``tenants``.  A dispatcher
        thread replays every arrival on the wall clock over ``duration_s``
        seconds and a pool of ``workers`` threads drains the ready queue in
        (priority, arrival) order.

        Per arrival, in order:

        1. **Admission** (``shed=True``): a sheddable tenant's query whose
           quoted wait — queue backlog ahead of it × EWMA service time ÷
           workers, plus the broker's memory-admission quote — already
           exceeds its deadline is shed (:class:`ShedQuery`); running it
           would burn capacity on a result nobody can use.  Non-sheddable
           tenants are always admitted.
        2. **Deadline enforcement at dequeue**: an admitted sheddable query
           that starved past its deadline while queued is recorded as a
           :class:`FailedQuery` (``error="DeadlineExceeded"``) — an
           admission mistake, measured instead of served late.
           Non-sheddable tenants run regardless; a late completion shows up
           as ``slo_ok=False`` on the served record.
        3. **Preemption** (``preempt=True``): a positive-priority tenant
           whose memory admission would block first cancels one
           floor-degraded linear operator mid-spill
           (:meth:`~repro_torch.core.resource_broker.ResourceBroker.
           preempt_degraded`); the victim's operator re-runs on the tensor
           path (``ServedQuery.preempted``) instead of holding the spill
           wall in front of the premium tenant.

        Latency is the arrival→completion **sojourn** — queueing included,
        measured from the scheduled arrival time, so the report is free of
        coordinated omission by construction.  Every arrival ends as
        exactly one of served / shed / failed (``report.counts``).
        """
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        tenants = list(tenants)
        if not tenants:
            raise ValueError("need at least one TenantClass")
        by_name = {t.name: t for t in tenants}
        if len(by_name) != len(tenants):
            raise ValueError("duplicate tenant names")
        for label, mapping in (("workloads", workloads),
                               ("arrivals", arrivals)):
            if set(mapping) != set(by_name):
                raise ValueError(
                    f"{label} keys {sorted(mapping)} must match tenant "
                    f"names {sorted(by_name)}")
        workloads = {name: list(wl) for name, wl in workloads.items()}
        for name, wl in workloads.items():
            if not wl:
                raise ValueError(f"empty workload for tenant {name!r}")

        # Warmup: converge caches off the clock AND seed the service-time
        # EWMA the admission quote needs before the first real arrival.
        svc_ewma = 0.0
        for r in range(max(1, warmup)):
            for name in sorted(workloads):
                for item in workloads[name]:
                    try:
                        with Timer() as t:
                            self.submit(item)
                    except BrokerInvariantViolation:
                        raise
                    except (Exception, SimulatedCrash):
                        # a poisoned item fails here AND during serving —
                        # there it becomes a FailedQuery sample, so warmup
                        # must not abort the run over it
                        continue
                    svc_ewma = (t.elapsed if svc_ewma == 0.0
                                else 0.7 * svc_ewma + 0.3 * t.elapsed)

        # The full arrival schedule, merged across tenants in time order.
        # Workload items cycle per tenant, so every item sees traffic.
        events = []
        for name in sorted(workloads):
            ts = arrivals[name].times(duration_s)
            n_items = len(workloads[name])
            for i, t_off in enumerate(ts):
                events.append((float(t_off), name, i % n_items))
        events.sort()
        submitted = len(events)

        base = self._snapshot_base()
        probe_bytes = self.session.executor.work_mem
        served: List[ServedQuery] = []
        shed_q: List[ShedQuery] = []
        failed: List[FailedQuery] = []
        errors: List[BaseException] = []
        cond = threading.Condition()
        ready: list = []        # heap of (-priority, seq, payload)
        inflight = [0]
        done_dispatching = [False]
        abort = [False]
        ewma = [svc_ewma]

        def quoted_wait(tc: TenantClass) -> float:
            """Admission-time wait estimate: ready-queue work ahead of this
            tenant (same or higher priority) plus in-flight work, spread
            over the pool, plus the broker's memory-admission quote.  A
            sharded server (``max_shards > 1``) additionally charges the
            device gang wait — the max over the per-lane expected waits a
            fan-out dispatch would block on; single-lane servers skip the
            term so their admission pricing is the single-lane one."""
            with cond:
                ahead = inflight[0] + sum(
                    1 for e in ready if -e[0] >= tc.priority)
                est = (ahead / workers) * ewma[0]
            if self.governor is not None:
                q = self.broker.price(
                    ResourceRequest("memory", need_bytes=probe_bytes))
                est += q.expected_wait_s
            nlanes = self.session.executor.max_shards
            if nlanes > 1:
                dq = self.broker.price(
                    ResourceRequest("device", lanes=nlanes))
                est += dq.expected_wait_s
            return est

        def dispatcher() -> None:
            t0 = time.perf_counter()
            for seq, (t_off, name, idx) in enumerate(events):
                # sleep to the scheduled arrival in small slices so an
                # abort (invariant violation) stops the storm promptly
                while not abort[0]:
                    lag = (t0 + t_off) - time.perf_counter()
                    if lag <= 0:
                        break
                    time.sleep(min(lag, 0.05))
                if abort[0]:
                    return
                tc = by_name[name]
                if shed and tc.sheddable:
                    est = quoted_wait(tc)
                    if est > tc.deadline_s:
                        with cond:
                            shed_q.append(ShedQuery(
                                tenant=name, seq=seq, workload_idx=idx,
                                arrival_s=t_off, quoted_wait_s=est,
                                deadline_s=tc.deadline_s))
                        continue
                with cond:
                    heapq.heappush(ready,
                                   (-tc.priority, seq, (t0 + t_off, name,
                                                        idx)))
                    cond.notify()
            with cond:
                done_dispatching[0] = True
                cond.notify_all()

        def worker(wid: int) -> None:
            while True:
                with cond:
                    while not ready and not done_dispatching[0] \
                            and not abort[0]:
                        cond.wait()
                    if abort[0] or (not ready and done_dispatching[0]):
                        return
                    _, seq, (arr_abs, name, idx) = heapq.heappop(ready)
                    inflight[0] += 1
                tc = by_name[name]
                try:
                    lag = time.perf_counter() - arr_abs
                    if tc.sheddable and lag > tc.deadline_s:
                        # admitted, then starved past its deadline in queue:
                        # an admission mistake, recorded rather than served
                        # late (the result is already worthless)
                        with cond:
                            failed.append(FailedQuery(
                                worker=wid, seq=seq, workload_idx=idx,
                                error="DeadlineExceeded",
                                message=f"queued {lag:.3f}s > deadline "
                                        f"{tc.deadline_s:.3f}s",
                                tenant=name, wall_s=lag))
                        continue
                    if preempt and tc.priority > 0 \
                            and self.governor is not None:
                        _, would_block, waiters = \
                            self.governor.admission_probe(probe_bytes)
                        if would_block or waiters > 0:
                            # a premium tenant must not park behind a
                            # best-effort spill wall: cancel one degraded
                            # linear operator; it re-runs on the tensor path
                            self.broker.preempt_degraded(1)
                    with Timer() as t:
                        res = self.submit(workloads[name][idx])
                    sojourn = time.perf_counter() - arr_abs
                    rec = self._served_record(
                        res, worker=wid, seq=seq, idx=idx, wall_s=sojourn,
                        keep=keep_relations, tenant=name,
                        arrival_s=0.0, service_s=t.elapsed,
                        slo_ok=sojourn <= tc.deadline_s)
                    with cond:
                        served.append(rec)
                        ewma[0] = (t.elapsed if ewma[0] == 0.0
                                   else 0.7 * ewma[0] + 0.3 * t.elapsed)
                except BrokerInvariantViolation as e:
                    with cond:  # the one non-survivable failure
                        errors.append(e)
                        abort[0] = True
                        cond.notify_all()
                    return
                except (Exception, SimulatedCrash) as e:
                    with cond:
                        failed.append(FailedQuery(
                            worker=wid, seq=seq, workload_idx=idx,
                            error=type(e).__name__, message=str(e),
                            tenant=name,
                            wall_s=time.perf_counter() - arr_abs))
                except BaseException as e:  # KeyboardInterrupt etc.
                    with cond:
                        errors.append(e)
                        abort[0] = True
                        cond.notify_all()
                    return
                finally:
                    with cond:
                        inflight[0] -= 1

        disp = threading.Thread(target=dispatcher, daemon=True)
        pool = [threading.Thread(target=worker, args=(w,), daemon=True)
                for w in range(workers)]
        with Timer() as run_t:
            disp.start()
            for th in pool:
                th.start()
            disp.join()
            for th in pool:
                th.join()
        if errors:
            raise errors[0]

        # arrival offsets were only known to the dispatcher on the absolute
        # clock; stamp the report-relative offsets back onto the records
        for rec in served:
            rec.arrival_s = events[rec.seq][0]
        for f in failed:
            f.arrival_s = events[f.seq][0]
        return self._build_report(
            base, served, shed_q, failed, submitted=submitted,
            wall_s=run_t.elapsed, concurrency=workers)
