"""Queue-aware resource broker: one layer that owns "what will this request
actually wait for, right now".

Before this module the serving layer had three independent resource
mechanisms, none of which could see the queues the others created:

  * the :class:`~repro_torch.core.memory_governor.MemoryGovernor` priced memory
    (full grant / floor degradation / blocking admission) but its
    ``would_grant`` peek was blind to *admission wait* — when not even the
    floor was free it reported the floor the waiter would eventually get,
    and the wait itself was invisible to path pricing;
  * a module-global FIFO ticket lock in ``core/fused.py`` serialized device
    programs invisibly — queue depth existed, but nothing could observe or
    price it;
  * the :class:`~repro_torch.core.path_selector.PathSelector` priced *execution*
    cost only, so under load ``auto`` happily chose a small linear operator
    that then parked in admission while the tensor path would have run
    immediately (ROADMAP open items 1–3).

The :class:`ResourceBroker` unifies them.  Every execution path acquires
resources through typed leases — :class:`MemoryLease` for linear operators
(wrapping the governor's grant), :class:`DeviceLease` for fused *and*
per-operator tensor dispatch — and the broker tracks, per resource, live
queue depth and EWMA wait/hold times.  One :meth:`ResourceBroker.price`
entry point turns a :class:`ResourceRequest` into a :class:`PressureQuote`
(expected grant + expected admission/queue wait) that the selector folds
into path costs, so the decision layer finally prices *run-time conditions*
(Graefe's robustness argument), not just compile-time estimates.

Device micro-batching: the :class:`DeviceQueue` admits leases in strict
arrival order, but queued leases that share a ``batch_key`` (the fused
pipeline passes its compiled-shape cache key; the per-operator tensor path
uses a shared ``"per-op"`` bucket) are admitted **together** as one
coalesced dispatch group instead of running strictly one-at-a-time — the
programs are identical compiled artifacts, so overlapping them changes
scheduling only, never results (asserted bit-for-bit in tests and fig12).

**Price-and-hold reservations** close the quote's decide-then-act gap: a
:class:`PressureQuote` is non-binding, so between "the quote said the full
grant is free" and "the operator acquires", a concurrent grant can take the
bytes — ``auto`` then runs its *linear* decision on a *degraded* grant it
never priced (a decide-then-lose incident).
:meth:`ResourceBroker.reserve` pairs the quote with a short-TTL
:class:`~repro_torch.core.memory_governor.MemoryHold`: the quoted bytes are
committed at decision time, :meth:`memory_lease` converts the hold without
waiting, and a decision that goes the other way cancels it (the TTL reaps
anything leaked).  ``reservations=False`` is the quote-only ablation.

**Preemption**: floor-degraded linear operators register a
:class:`PreemptToken` while they run; :meth:`ResourceBroker.
preempt_degraded` cancels them mid-spill (they poll the token at partition
/ run boundaries) so the executor can requeue the operator on the tensor
path — graceful degradation instead of a multi-second spill wall blocking
a premium tenant's admission.

``REPRO_DEVICE_SERIALIZE=0`` keeps its escape-hatch meaning: the broker
grants device leases without serializing (multi-device hosts where XLA can
genuinely overlap arbitrary programs).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .faults import FaultInjector, PreemptedError
from .memory_governor import MemoryGovernor, MemoryGrant, MemoryHold
from .metrics import NO_SPAN, span, spans_on

__all__ = ["ResourceBroker", "ResourceRequest", "PressureQuote",
           "Reservation", "PreemptToken", "MemoryLease", "DeviceLease",
           "DeviceGangLease", "DeviceQueue", "BrokerStats",
           "default_broker"]

# EWMA smoothing for wait/hold/service observations: heavy enough that one
# stall cannot whipsaw the pricing, light enough to track a shifting load
# within ~a dozen observations.
_EWMA_ALPHA = 0.3


# ---------------------------------------------------------------------------
# Request / quote types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResourceRequest:
    """What an execution path is about to acquire.

    ``resource`` is ``"memory"`` (a linear operator's linearized-intermediate
    footprint in ``need_bytes``) or ``"device"`` (one compiled-program
    dispatch; ``batch_key`` may name the compiled-shape bucket when the
    caller already knows it — coalescible queued work is then not counted
    as wait).
    """

    resource: str
    need_bytes: int = 0
    batch_key: object = None
    # Device requests only: mesh lanes a sharded dispatch would gang over
    # (1 = the classic single-lane dispatch).  Pricing then quotes every
    # requested lane so admission sees per-lane contention.
    lanes: int = 1

    def __post_init__(self):
        if self.resource not in ("memory", "device"):
            raise ValueError(f"unknown resource {self.resource!r}")
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")


@dataclasses.dataclass
class PressureQuote:
    """The broker's answer to "what would this request get, right now?".

    ``grant_bytes`` is the expected grant (memory requests only — the same
    full-or-policy sizing :meth:`MemoryGovernor.acquire` would apply);
    ``expected_wait_s`` is the expected admission/queue wait *before* the
    resource is held — the term the old ``would_grant`` peek could not see;
    ``queue_depth`` the live number of holders+waiters ahead; ``would_block``
    whether acquisition would park in admission right now.  A broker with
    ``queue_pricing=False`` (the fig12 "queue-blind" baseline) always quotes
    ``expected_wait_s=0`` — grant sizing stays pressure-aware, wait pricing
    is what is being ablated.
    """

    resource: str
    grant_bytes: int = 0
    expected_wait_s: float = 0.0
    queue_depth: int = 0
    would_block: bool = False
    # Device quotes: per-lane expected waits for the request's ``lanes``
    # (lane 0 first; lanes the broker has not yet materialized quote 0.0).
    # ``expected_wait_s`` is then the gang's critical path — the max over
    # these — which for the classic single-lane request is exactly the
    # lane-0 wait.
    lane_waits: Tuple[float, ...] = ()
    # Memory quotes under a tiered governor: the per-tier spill quotas the
    # grant would carry ((t0, t1, t2) bytes; None = unbounded) and the
    # tiers' modeled per-byte service times ((t0, t1, t2) seconds/byte;
    # None = use the cost model's calibrated io_byte_cost).  These are the
    # bandwidth/latency terms the selector folds into tiered-linear spill
    # pricing — an untiered governor quotes both as None.
    tier_quotas: Optional[Tuple[Optional[int], ...]] = None
    tier_byte_s: Optional[Tuple[Optional[float], ...]] = None


class Reservation:
    """A priced decision input that cannot be lost: quote + short-TTL hold.

    ``quote`` is what the selector prices against.  When the broker placed a
    :class:`~repro_torch.core.memory_governor.MemoryHold` behind it (``held`` is
    true), the quoted ``grant_bytes`` are *committed* — converting via
    :meth:`ResourceBroker.memory_lease` gets exactly that size with zero
    admission wait.  A quote-only reservation (``reservations=False``
    ablation, device resources, or a would-block probe where there is
    nothing truthful to hold) carries no hold and keeps the historical race.
    :meth:`cancel` is idempotent and safe after conversion; the hold's TTL
    backstops any path that forgets.
    """

    __slots__ = ("quote", "_hold", "_broker")

    def __init__(self, quote: PressureQuote, hold: Optional[MemoryHold],
                 broker: "ResourceBroker"):
        self.quote = quote
        self._hold = hold
        self._broker = broker

    @property
    def held(self) -> bool:
        return self._hold is not None and self._hold.active

    def cancel(self) -> None:
        if self._hold is not None:
            self._hold.cancel()

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> None:
        self.cancel()


class PreemptToken:
    """Cooperative cancellation handle for a floor-degraded linear operator.

    The operator polls :meth:`check` at partition/run boundaries inside its
    spill loops; :meth:`cancel` (called by :meth:`ResourceBroker.
    preempt_degraded`) makes the next poll raise
    :class:`~repro_torch.core.faults.PreemptedError`, which the executor catches
    to requeue the operator on the tensor path.
    """

    __slots__ = ("_flag",)

    def __init__(self):
        self._flag = threading.Event()

    def cancel(self) -> None:
        self._flag.set()

    @property
    def cancelled(self) -> bool:
        return self._flag.is_set()

    def check(self) -> None:
        if self._flag.is_set():
            raise PreemptedError(
                "floor-degraded linear operator preempted mid-spill")


# ---------------------------------------------------------------------------
# Typed leases
# ---------------------------------------------------------------------------

class MemoryLease:
    """A broker-issued hold on the governor's budget.

    Wraps the governor's :class:`~repro_torch.core.memory_governor.MemoryGrant`
    (same sizing, same never-over-budget invariant) and reports its hold
    duration back to the broker on release, which is where the EWMA hold
    time that prices future admission waits comes from.  Release exactly
    once — a second :meth:`release` raises (the grant's double-release
    guard); the context-manager exit is idempotent.
    """

    __slots__ = ("_broker", "_grant", "_t_admit")

    def __init__(self, broker: "ResourceBroker", grant: MemoryGrant):
        self._broker = broker
        self._grant = grant
        self._t_admit = time.perf_counter()

    @property
    def size(self) -> int:
        return self._grant.size

    @property
    def requested(self) -> int:
        return self._grant.requested

    @property
    def wait_s(self) -> float:
        return self._grant.wait_s

    @property
    def degraded(self) -> bool:
        return self._grant.degraded

    @property
    def tier_quotas(self):
        """Per-tier spill quotas when the underlying grant is a
        :class:`~repro_torch.core.memory_governor.TieredGrant`, else None."""
        return getattr(self._grant, "quotas", None)

    @property
    def released(self) -> bool:
        return self._grant.released

    def release(self) -> None:
        self._grant.release()  # raises on double release
        self._broker._record_mem_hold(time.perf_counter() - self._t_admit)

    def __enter__(self) -> "MemoryLease":
        return self

    def __exit__(self, *exc) -> None:
        if not self._grant.released:
            self.release()


class _Ticket:
    __slots__ = ("batch_key", "admitted", "batched", "t_admit", "group",
                 "span")

    def __init__(self, batch_key):
        self.batch_key = batch_key
        self.admitted = False
        self.batched = False
        self.t_admit = 0          # time.perf_counter_ns() at admission
        # leases admitted in this ticket's group so far, joiners included:
        # one list shared by the group's tickets
        self.group = None
        self.span = NO_SPAN       # its ``lease_hold`` span


class DeviceLease:
    """An admitted device dispatch slot.

    ``wait_s`` is the time spent queued before admission (load, not
    execution cost — callers stamp it into ``OpMetrics.queue_wait_s`` so it
    stays out of runtime-profile feedback); ``batched`` marks a lease that
    ran as part of a coalesced same-``batch_key`` group (live: a solo lease
    becomes batched the moment a same-shape arrival joins its round).
    """

    __slots__ = ("_queue", "_ticket", "wait_s", "_released")

    def __init__(self, queue: "DeviceQueue", ticket: Optional[_Ticket],
                 wait_s: float):
        self._queue = queue
        self._ticket = ticket
        self.wait_s = wait_s
        self._released = False

    @property
    def batched(self) -> bool:
        return self._ticket is not None and self._ticket.batched

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if self._released:
            raise RuntimeError("device lease released twice")
        self._released = True
        self._queue._release(self._ticket)

    def __enter__(self) -> "DeviceLease":
        return self

    def __exit__(self, *exc) -> None:
        if not self._released:
            self.release()


class DeviceGangLease:
    """An admitted all-lane dispatch for a sharded fragment.

    One :class:`DeviceLease` per mesh lane, acquired in FIXED lane order
    (0..N-1) — every gang and every single-lane dispatch (always lane 0)
    acquires along the same total order, so lane acquisition can never
    deadlock — and released together.  ``wait_s`` is the acquisition's
    total blocked time across lanes (on a serial host the gang's waits
    accumulate; ``lane_waits`` keeps the per-lane attribution).
    """

    __slots__ = ("_leases", "wait_s", "lane_waits", "_released", "_span")

    def __init__(self, leases: List[DeviceLease], hold=NO_SPAN):
        self._leases = leases
        self.lane_waits = tuple(l.wait_s for l in leases)
        self.wait_s = sum(self.lane_waits)
        self._released = False
        self._span = hold

    @property
    def lanes(self) -> int:
        return len(self._leases)

    @property
    def batched(self) -> bool:
        return any(l.batched for l in self._leases)

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if self._released:
            raise RuntimeError("device gang lease released twice")
        self._released = True
        for lease in reversed(self._leases):
            lease.release()
        self._span.set("group", 1).set("lanes", len(self._leases)).close()

    def __enter__(self) -> "DeviceGangLease":
        return self

    def __exit__(self, *exc) -> None:
        if not self._released:
            self.release()


# ---------------------------------------------------------------------------
# Device dispatch queue (replaces fused._FifoLock)
# ---------------------------------------------------------------------------

class DeviceQueue:
    """Strict-arrival-order device admission with same-shape coalescing.

    The device is a serially-shared resource: concurrent serving sessions
    funnel compiled-program launches through this queue so a query's device
    phase runs at full speed instead of time-slicing against seven
    neighbors.  Like the ticket lock it replaces, admission order is the
    arrival order — a plain ``threading.Lock`` lets the releasing thread
    barge back in and manufactures exactly the p99 tail the queue exists to
    remove.  Unlike the lock, the queue is *observable* (depth, EWMA wait,
    EWMA service time feed :meth:`ResourceBroker.price`) and **coalesces**:
    when the device frees up, the head ticket is admitted together with
    every queued ticket sharing its ``batch_key`` — one micro-batched
    dispatch group instead of N serial rounds of the same compiled program.
    A same-key arrival while a keyed group is RUNNING joins the in-flight
    round immediately (the members are independent identical compiled
    artifacts, not a barrier) — but only while no other-key ticket is
    waiting, so cross-shape arrival order is never starved.  A ``batch_key``
    of ``None`` is always exclusive.

    ``max_group`` bounds a coalesced group's size (admission-time AND
    in-flight joins) — the classic serving-system batch-size cap: an
    unbounded group time-slices all its members against each other, which
    on an oversubscribed device turns a homogeneous stream's tail into a
    co-runner-count lottery.  ``None`` = unbounded.
    """

    def __init__(self, max_group: Optional[int] = None):
        if max_group is not None and max_group < 1:
            raise ValueError(f"max_group must be >= 1, got {max_group}")
        self.max_group = max_group
        self._cond = threading.Condition()
        self._waiting: List[_Ticket] = []
        self._active: List[_Ticket] = []
        self._active_key = None  # batch key of the running group, if keyed
        # cumulative counters (snapshot via stats())
        self._dispatches = 0
        self._coalesced = 0
        self._bypassed = 0
        self._peak_depth = 0
        self._ewma_wait_s = 0.0
        self._ewma_service_s = 0.0

    @staticmethod
    def serialize() -> bool:
        """``REPRO_DEVICE_SERIALIZE=0`` → leases are granted immediately,
        without serializing (or pricing) device dispatch."""
        return os.environ.get("REPRO_DEVICE_SERIALIZE", "1") != "0"

    # -- lease lifecycle -----------------------------------------------------
    def acquire(self, batch_key=None, traced: bool = True) -> DeviceLease:
        """Queue for the device and return the admitted lease.

        The wait is a ``lease_wait`` span (``depth``: leases waiting and
        active at arrival; a join to the in-flight group is a zero-length
        span), and the hold from admission to release a ``lease_hold``
        span, open on this thread meanwhile so the launch and the fetch nest
        under it (``group``: the leases admitted in its group, joiners
        included, counted at release).  ``traced=False`` leaves both to the
        caller (a gang records its own)."""
        if not self.serialize():
            with self._cond:
                self._dispatches += 1
                self._bypassed += 1
            return DeviceLease(self, None, 0.0)
        t0 = time.perf_counter_ns()
        ticket = _Ticket(batch_key)
        with self._cond:
            depth = len(self._waiting) + len(self._active)
            if (batch_key is not None and self._active
                    and self._active_key == batch_key and not self._waiting
                    and (self.max_group is None
                         or len(self._active) < self.max_group)):
                # join the in-flight same-shape round: no missed-round
                # penalty for lockstep serving traffic, and nobody is
                # waiting whose arrival order this could violate
                ticket.admitted = True
                ticket.batched = True
                ticket.group = self._active[0].group
                ticket.group[0] += 1
                # a previously-solo round becomes batched when joined:
                # count every member that newly shares a group, not just
                # the joiner, so `coalesced` means "leases that ran in a
                # batched group"
                for t in self._active:
                    if not t.batched:
                        t.batched = True
                        self._coalesced += 1
                self._active.append(ticket)
                self._peak_depth = max(self._peak_depth, len(self._active))
                ticket.t_admit = time.perf_counter_ns()
                self._dispatches += 1
                self._coalesced += 1
                self._ewma_wait_s = _ewma(self._ewma_wait_s, 0.0)
                wait = 0.0
            else:
                self._waiting.append(ticket)
                self._peak_depth = max(self._peak_depth, depth + 1)
                self._admit_locked()
                while not ticket.admitted:
                    self._cond.wait()
                ticket.t_admit = time.perf_counter_ns()
                wait = (ticket.t_admit - t0) / 1e9
                self._dispatches += 1
                self._ewma_wait_s = _ewma(self._ewma_wait_s, wait)
        if traced:
            span("lease_wait", t0).set("depth", depth).close(ticket.t_admit)
            ticket.span = span("lease_hold", ticket.t_admit)
        return DeviceLease(self, ticket, wait)

    def _admit_locked(self) -> None:
        """Admit the next dispatch group (lock held): the head of the queue
        plus every queued ticket sharing its batch_key."""
        if self._active or not self._waiting:
            return
        head = self._waiting[0]
        group = [head]
        if head.batch_key is not None:
            for t in self._waiting[1:]:
                if (self.max_group is not None
                        and len(group) >= self.max_group):
                    break
                if t.batch_key == head.batch_key:
                    group.append(t)
        batched = len(group) > 1
        members = [len(group)]
        for t in group:
            self._waiting.remove(t)
            t.admitted = True
            t.batched = batched
            t.group = members
        self._active = group
        self._active_key = head.batch_key
        if batched:
            self._coalesced += len(group)
        self._cond.notify_all()

    def _release(self, ticket: Optional[_Ticket]) -> None:
        if ticket is None:  # bypass lease (REPRO_DEVICE_SERIALIZE=0)
            return
        t1 = time.perf_counter_ns()
        with self._cond:
            self._active.remove(ticket)
            self._ewma_service_s = _ewma(self._ewma_service_s,
                                         (t1 - ticket.t_admit) / 1e9)
            group = ticket.group[0]
            if not self._active:
                self._active_key = None
                self._admit_locked()
        ticket.span.set("group", group).close(t1)

    # -- pricing -------------------------------------------------------------
    def expected_wait(self, batch_key=None):
        """``(expected_wait_s, queue_depth)`` for a new request.

        Expected wait = EWMA service time × the number of *serial dispatch
        rounds* ahead: the running group (if any) plus one round per distinct
        batch_key among the waiters (same-key waiters coalesce into one
        round; exclusive ``None`` tickets are a round each).  A request that
        names a ``batch_key`` already queued would join that round and does
        not count it.  A request with NO key yet (the selector prices before
        the compiled shape is known) optimistically assumes it will coalesce
        with one keyed queued round when any exists — serving workloads
        repeat shapes, and counting a round the request would join as wait
        double-charges the tensor path and flips ``auto`` toward a linear
        choice that then parks in admission (the exact pathology this
        pricing exists to remove).
        """
        with self._cond:
            depth = len(self._waiting) + len(self._active)
            if not self.serialize():
                return 0.0, depth
            if (self._active and self._active_key is not None
                    and not self._waiting
                    and (batch_key is None or batch_key == self._active_key)
                    and (self.max_group is None
                         or len(self._active) < self.max_group)):
                return 0.0, depth  # would join the in-flight round
            rounds = 1 if self._active else 0
            keyed = set()
            for t in self._waiting:
                if t.batch_key is None:
                    rounds += 1
                elif t.batch_key not in keyed:
                    keyed.add(t.batch_key)
                    rounds += 1
            if keyed and (batch_key in keyed or batch_key is None):
                rounds -= 1  # we would (likely) coalesce into that round
            return rounds * self._ewma_service_s, depth

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": len(self._waiting) + len(self._active),
                "dispatches": self._dispatches,
                "coalesced": self._coalesced,
                "bypassed": self._bypassed,
                "peak_depth": self._peak_depth,
                "ewma_wait_s": self._ewma_wait_s,
            }


def _ewma(old: float, sample: float) -> float:
    return sample if old == 0.0 else old + _EWMA_ALPHA * (sample - old)


# ---------------------------------------------------------------------------
# Broker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BrokerStats:
    """Snapshot of the broker's accounting (see :meth:`ResourceBroker.
    stats`).  Counters are cumulative; EWMA/peak entries are gauges —
    :meth:`since` subtracts a baseline snapshot's counters for per-run
    reporting (the same discipline :class:`~repro_torch.core.server.ServeReport`
    applies to governor stats)."""

    device_bypassed: int = 0        # REPRO_DEVICE_SERIALIZE=0 grants
    preempt_registered: int = 0     # degraded linear ops that ran preemptible
    preemptions: int = 0            # tokens actually cancelled
    switches: int = 0               # guard-initiated mid-query path switches
    # Per-lane DeviceQueue snapshots (lane 0 first — the classic
    # single-device queue; lanes beyond 0 exist only on brokers serving
    # sharded dispatch).  Each entry is the lane's ``DeviceQueue.stats()``
    # dict: depth, peak_depth, dispatches, coalesced, bypassed,
    # ewma_wait_s.
    lanes: Tuple[Dict[str, float], ...] = ()

    _LANE_COUNTERS = ("dispatches", "coalesced", "bypassed")

    def since(self, base: "BrokerStats") -> "BrokerStats":
        out = dataclasses.replace(self)
        for f in ("device_bypassed", "preempt_registered", "preemptions",
                  "switches"):
            setattr(out, f, getattr(self, f) - getattr(base, f))
        lanes = []
        for i, lane in enumerate(self.lanes):
            lane = dict(lane)
            if i < len(base.lanes):
                for k in self._LANE_COUNTERS:
                    lane[k] = lane[k] - base.lanes[i].get(k, 0)
            lanes.append(lane)
        out.lanes = tuple(lanes)
        return out


class ResourceBroker:
    """Issues typed leases over the serving-scope resources and prices them.

    ``governor=None`` builds a device-only broker (ungoverned sessions);
    ``device_queue=None`` gives the broker its own private queue (the
    per-server configuration) — pass a shared :class:`DeviceQueue` when
    several brokers in one process must serialize against the same physical
    device (the module-level :func:`default_broker` serves exactly that
    role for broker-less executors).  ``queue_pricing=False`` disables the
    wait terms in :meth:`price` — the "queue-blind" ablation fig12 measures
    against — while leases and grant sizing behave identically.
    """

    def __init__(self, governor: Optional[MemoryGovernor] = None,
                 device_queue: Optional[DeviceQueue] = None,
                 queue_pricing: bool = True, reservations: bool = True,
                 reservation_ttl_s: float = 0.25,
                 faults: Optional[FaultInjector] = None):
        self.governor = governor
        self.device = device_queue if device_queue is not None else DeviceQueue()
        # Dispatch lanes for sharded fragments: lane 0 IS self.device (the
        # classic single-device queue — all existing accounting keeps
        # describing it); further lanes are materialized on demand by
        # ensure_lanes() and share lane 0's max_group.
        self._lanes: List[DeviceQueue] = [self.device]
        self.queue_pricing = bool(queue_pricing)
        # price-and-hold on/off: False is the quote-only ablation
        self.reservations = bool(reservations)
        self.reservation_ttl_s = float(reservation_ttl_s)
        self.faults = faults
        self._lock = threading.Lock()
        self._mem_ewma_wait_s = 0.0
        self._mem_ewma_hold_s = 0.0
        self._preemptible: List[PreemptToken] = []
        self._preempt_registered = 0
        self._preemptions = 0
        self._switches = 0

    # -- leases --------------------------------------------------------------
    def memory_lease(self, need_bytes: int, timeout: Optional[float] = None,
                     reservation: Optional[Reservation] = None) -> MemoryLease:
        """Acquire a memory lease (blocks under admission control exactly as
        :meth:`MemoryGovernor.acquire`); the observed admission wait feeds
        the EWMA that prices future memory quotes.

        ``reservation`` redeems a :meth:`reserve` decision: an active hold
        converts without waiting; a quote-only reservation acquires
        normally."""
        if self.governor is None:
            raise RuntimeError("broker has no memory governor; memory leases "
                               "require a governed session")
        if self.faults is not None:
            self.faults.on_memory_grant()
        hold = reservation._hold if reservation is not None else None
        grant = self.governor.acquire(need_bytes, timeout=timeout, hold=hold)
        if grant.wait_s > 0:
            with self._lock:
                self._mem_ewma_wait_s = _ewma(self._mem_ewma_wait_s,
                                              grant.wait_s)
        return MemoryLease(self, grant)

    @property
    def lanes(self) -> Tuple[DeviceQueue, ...]:
        with self._lock:
            return tuple(self._lanes)

    def ensure_lanes(self, n: int) -> None:
        """Materialize dispatch lanes up to ``n`` (idempotent, never
        shrinks).  New lanes inherit lane 0's ``max_group`` so sharded and
        single-lane dispatch coalesce under the same batching policy."""
        n = int(n)
        with self._lock:
            while len(self._lanes) < n:
                self._lanes.append(DeviceQueue(max_group=self.device.max_group))

    def device_lease(self, batch_key=None, lanes: int = 1):
        """Acquire a device dispatch slot (blocks per the queue discipline;
        coalesces with queued same-``batch_key`` leases).

        ``lanes=N`` (N >= 2) acquires a :class:`DeviceGangLease` over lanes
        0..N-1 in fixed lane order — the all-device admission a sharded
        fragment's ``shard_map`` launch needs.  Lane order is a total
        order shared with single-lane dispatch (always lane 0), so gangs
        can never deadlock against each other or against classic leases.
        """
        if self.faults is not None:
            self.faults.on_device_dispatch()
        if lanes <= 1:
            return self.device.acquire(batch_key)
        self.ensure_lanes(lanes)
        with self._lock:
            queues = list(self._lanes[:lanes])
        # Gangs never coalesce: a sharded launch runs cross-device
        # collectives, and two gangs admitted as one batch_key group would
        # interleave collective launches — on the host platform that is a
        # rendezvous deadlock, not a slowdown.  Strict per-lane exclusion in
        # fixed lane order serializes gangs against each other and against
        # single-lane (lane 0) dispatch.
        held: List[DeviceLease] = []
        t0 = time.perf_counter_ns()
        depth = (max(q.stats()["depth"] for q in queues) if spans_on()
                 else 0)
        try:
            for q in queues:
                held.append(q.acquire(None, traced=False))
        except BaseException:
            for lease in reversed(held):
                lease.release()
            raise
        t_admit = time.perf_counter_ns()
        span("lease_wait", t0).set("depth", depth).close(t_admit)
        return DeviceGangLease(held, span("lease_hold", t_admit))

    # -- reservations --------------------------------------------------------
    def reserve(self, request: ResourceRequest) -> Reservation:
        """Price a request and — for memory, when reservations are enabled
        and the grant would not block — commit the quoted bytes behind a
        short-TTL hold.  The returned :class:`Reservation` either converts
        (pass it to :meth:`memory_lease`) or must be cancelled; the TTL
        reaps anything a crashed decision leaks.  Device requests and the
        quote-only ablation return an unheld reservation (plain quote
        semantics)."""
        if (request.resource == "memory" and self.reservations
                and self.governor is not None):
            hold = self.governor.hold(request.need_bytes,
                                      ttl_s=self.reservation_ttl_s)
            if hold is not None:
                quote = PressureQuote("memory", hold.size, 0.0,
                                      0, False)
                return Reservation(quote, hold, self)
        return Reservation(self.price(request), None, self)

    # -- preemption ----------------------------------------------------------
    def register_preemptible(self, token: PreemptToken) -> None:
        """A floor-degraded linear operator announces it can be cancelled
        mid-spill (it polls the token at partition/run boundaries)."""
        with self._lock:
            self._preemptible.append(token)
            self._preempt_registered += 1

    def unregister_preemptible(self, token: PreemptToken) -> None:
        with self._lock:
            try:
                self._preemptible.remove(token)
            except ValueError:
                pass  # already preempted away

    def preempt_degraded(self, max_n: Optional[int] = None) -> int:
        """Cancel up to ``max_n`` registered floor-degraded linear operators
        (all of them when ``None``): each abandons its spill at the next
        poll and its query re-runs the operator on the tensor path.  Returns
        the number preempted.  Called by the serving layer when a
        higher-priority tenant's admission would otherwise block behind a
        spill wall."""
        with self._lock:
            victims = (self._preemptible[:] if max_n is None
                       else self._preemptible[:max_n])
            for t in victims:
                self._preemptible.remove(t)
            self._preemptions += len(victims)
        for t in victims:
            t.cancel()
        return len(victims)

    def note_switch(self) -> None:
        """Count a guard-initiated mid-query path switch (executor calls
        this when a SwitchPoint is taken).  Observability only — switching
        consumes no broker resource; the takeover path acquires its own
        leases through the normal sites."""
        with self._lock:
            self._switches += 1

    def _record_mem_hold(self, hold_s: float) -> None:
        with self._lock:
            self._mem_ewma_hold_s = _ewma(self._mem_ewma_hold_s, hold_s)

    # -- pricing -------------------------------------------------------------
    def price(self, request: ResourceRequest) -> PressureQuote:
        """Non-binding quote: expected grant + expected admission/queue wait
        for ``request`` *right now*.  Cheap (lock-held reads only), never
        blocks, never reserves anything."""
        if request.resource == "device":
            with self._lock:
                queues = list(self._lanes[:max(1, request.lanes)])
            lane_waits = []
            depth = 0
            for q in queues:
                w, d = q.expected_wait(request.batch_key)
                lane_waits.append(w)
                depth = max(depth, d)
            # lanes not yet materialized are idle: they quote 0 wait
            lane_waits += [0.0] * (max(1, request.lanes) - len(lane_waits))
            if not self.queue_pricing:
                lane_waits = [0.0] * len(lane_waits)
            # the gang's critical path; for lanes=1 exactly the lane-0 wait
            wait = max(lane_waits)
            return PressureQuote("device", 0, wait, depth, depth > 0,
                                 lane_waits=tuple(lane_waits))
        gov = self.governor
        if gov is None:
            return PressureQuote("memory", max(1, int(request.need_bytes)),
                                 0.0, 0, False)
        size, would_block, waiters = gov.admission_probe(request.need_bytes)
        wait = 0.0
        if (self.queue_pricing and gov.full_grant_wait_s > 0
                and size < max(1, int(request.need_bytes))):
            # a degraded-sized grant first waits (up to full_grant_wait_s)
            # for its full size in acquire()'s phase 1 — expected value of
            # a uniformly-arriving release is half the window
            wait = 0.5 * gov.full_grant_wait_s
        with self._lock:
            if would_block or waiters > 0:
                # Waiters with no would_block means the pool momentarily has
                # free bytes AND standing parked demand: those bytes are
                # ephemeral — a woken waiter grabs them before a request
                # that only decided now gets to acquire — so admission is
                # priced as contended either way.
                if self.queue_pricing:
                    # Expected admission wait: the larger of the observed
                    # admission-wait EWMA and the residual of the current
                    # hold (≈ half an EWMA hold) plus one full hold per
                    # waiter already parked ahead.  Hold times come from
                    # lease releases, so the signal exists even when wait
                    # pricing has been steering every request AWAY from
                    # blocking (no fresh wait observations to learn from).
                    wait = max(wait, self._mem_ewma_wait_s,
                               self._mem_ewma_hold_s * (0.5 + waiters))
        tier_quotas = tier_byte_s = None
        tiers = getattr(gov, "tiers", None)
        if tiers is not None:
            # fold the hierarchy's bandwidth/latency terms into the quote:
            # the quotas THIS grant size would carry plus each tier's
            # modeled per-byte service time (T1's includes its configured
            # latency + bandwidth cap)
            q = gov.policy.tier_quotas(size, max(1, int(request.need_bytes)),
                                       tiers)
            tier_quotas = (q.get("t0"), q.get("t1"), q.get("t2"))
            tier_byte_s = tiers.byte_costs()
        return PressureQuote("memory", size, wait, waiters,
                             would_block or waiters > 0,
                             tier_quotas=tier_quotas, tier_byte_s=tier_byte_s)

    # -- observability -------------------------------------------------------
    def stats(self) -> BrokerStats:
        with self._lock:
            lane_queues = list(self._lanes)
        lanes = tuple(q.stats() for q in lane_queues)
        with self._lock:
            return BrokerStats(
                lanes=lanes,
                device_bypassed=lanes[0]["bypassed"],
                preempt_registered=self._preempt_registered,
                preemptions=self._preemptions,
                switches=self._switches,
            )


# Process-wide broker for executors constructed without one: its device
# queue is THE device queue for every broker-less session in the process,
# preserving the pre-broker invariant that one physical device serializes
# all fused dispatch.  Sessions that own a governor get their own broker
# (and, by default, their own queue) — the per-server configuration.
_DEFAULT_BROKER = ResourceBroker()


def default_broker() -> ResourceBroker:
    return _DEFAULT_BROKER
