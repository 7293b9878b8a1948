"""Global memory governor: one budget, many concurrent queries.

The paper's tail-latency claim is about memory *under contention*: a single
query with a private ``work_mem`` never reproduces the phase transition,
because nothing ever takes its memory away.  Real servers (PostgreSQL with
hundreds of backends, REMOP's memory-aware operator scheduling) hand every
concurrent operator a slice of one finite pool — and the slice an operator
actually receives, not the configured ``work_mem``, decides whether it stays
in the fast in-memory regime or collapses into the spill regime.

:class:`MemoryGovernor` owns that pool.  Linear-path operators acquire a
:class:`MemoryGrant` before building their linearized intermediate (hash
table / sort runs) and release it when the operator completes:

  * a request is served **in full** when the budget allows — the operator
    runs exactly as it would have with a private ``work_mem``;
  * under pressure the grant is **degraded** by the configured
    :class:`GrantPolicy` — down to ``min_grant`` under the default
    :class:`FloorGrantPolicy`, or to a demand-weighted share of the free
    pool under :class:`ProportionalShareGrantPolicy` — the operator still
    runs, but with less memory than it wanted, which is what pushes it over
    the spill boundary (the contention-induced tail fig11 measures);
  * when not even ``min_grant`` is available the request **blocks**
    (admission control) until a running query releases memory — queueing
    delay instead of an out-of-memory failure.

The governor's hard invariant — asserted continuously and exposed for tests
via :attr:`GovernorStats.over_budget_events` / :attr:`GovernorStats.
peak_in_use` — is that the sum of outstanding grants never exceeds the
budget, *whatever the policy returns* (policy output is clamped centrally).
Tensor-path operators never acquire grants: device-resident execution is
precisely the path that does not build a host linearized intermediate, which
is why it sidesteps the contention this module models.

:meth:`would_grant` is the grant-size half of the pressure signal; the
queue-aware half (expected admission *wait*) lives in
:meth:`~repro_torch.core.resource_broker.ResourceBroker.price`, which reads
:meth:`admission_probe` — the peek that also reports whether acquisition
would block and how many waiters are already parked.

**Price-and-hold** closes the decide-then-act gap those peeks leave open: a
probe is non-binding, so ``auto`` could decide "linear fits in full" on a
quote and then *lose* the bytes to a concurrent grant before acquiring
(fig13's decide-then-lose incident).  :meth:`hold` places a short-TTL
:class:`MemoryHold` — the quoted bytes are *committed* (counted against the
budget alongside grants, so the invariant becomes ``in_use + held <=
total``) until the decision either converts the hold into a grant via
``acquire(..., hold=...)`` (no wait: the bytes are already committed),
cancels it (tensor path chosen), or the TTL reaps it (a decision that
crashed or stalled can never strand budget).  Expiry is lazy-but-prompt:
every lock acquisition reaps, and admission waits are bounded by the
nearest hold deadline so a waiter blocked only by an expiring hold wakes
when it lapses rather than sleeping forever.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Union

__all__ = ["MemoryGovernor", "MemoryGrant", "MemoryHold", "TieredGrant",
           "GovernorStats", "GrantPolicy", "FloorGrantPolicy",
           "ProportionalShareGrantPolicy", "BrokerInvariantViolation"]


class BrokerInvariantViolation(RuntimeError):
    """A resource-accounting invariant was broken (double release, negative
    budget, leaked hold conversion).  The one error class the serving layer
    treats as fatal: unlike a per-query failure, corrupted budget accounting
    poisons every subsequent admission decision, so the run must abort.
    Subclasses RuntimeError so existing double-release handling keeps
    working."""

MB = 1 << 20


# ---------------------------------------------------------------------------
# Grant degradation policies
# ---------------------------------------------------------------------------

class GrantPolicy:
    """Sizing for a request that cannot be served in full.

    ``degraded_size(requested, available, floor, demand_bytes)`` returns the
    bytes to grant; ``demand_bytes`` is the sum of *requested* bytes across
    outstanding grants and parked waiters (excluding this request) — the
    live demand picture a workload-aware policy weighs against.  The
    governor clamps the result into ``[floor, min(requested, available)]``
    regardless, so no policy can violate the budget invariant.
    """

    name = "base"

    def degraded_size(self, requested: int, available: int, floor: int,
                      demand_bytes: int) -> int:
        raise NotImplementedError

    def tier_quotas(self, granted: int, requested: int,
                    tiers) -> Dict[str, Optional[int]]:
        """Per-tier SPILL quotas accompanying a :class:`TieredGrant` when
        the governor has a spill-tier hierarchy attached (``tiers`` is a
        :class:`~repro_torch.core.tier.TierConfig`-shaped object).

        Default sizing: the compressed T0 pool may hold up to
        ``max(2 × grant, half the pool)`` — 2× because dictionary encoding
        + bit packing roughly halves the footprint, and at least half the
        pool because the operator that NEEDS the staircase is precisely
        the floor-degraded one (a 1 MB floor grant would otherwise get a
        2 MB T0 quota and route its whole spill to the slow tiers).  The
        quota bounds ONE operator's claim; the pool's global capacity cap
        still holds, so concurrent quotas may oversubscribe it safely
        (first-come admission, exactly like an OS page cache).  T1 is
        bounded by its configured capacity; T2 (disk) is the unbounded
        backstop (``None``).  Policies may override to shape the staircase
        differently.
        """
        cap = int(tiers.t0_capacity)
        t0 = min(cap, max(2 * int(granted), cap // 2))
        t1 = tiers.t1_capacity
        return {"t0": t0, "t1": None if t1 is None else int(t1), "t2": None}


class FloorGrantPolicy(GrantPolicy):
    """Full grant if it fits, else the admission floor — NOT "whatever is
    left".  A partially-filled grant spills anyway (its deficit is what it
    is) while stranding the remaining pool, so the queries that COULD have
    fit (the fast tier) start degrading too and the whole distribution
    collapses.  Floor-degrading keeps the pool liquid: operators that fit
    stay fast, operators that don't pay their own spill and nobody else's.
    """

    name = "floor"

    def degraded_size(self, requested, available, floor, demand_bytes):
        return floor


class ProportionalShareGrantPolicy(GrantPolicy):
    """Demand-weighted proportional share — the PostgreSQL
    ``hash_mem_multiplier`` analogue.

    A squeezed request receives its share of the *free* pool weighted by its
    estimated linearized-intermediate footprint (callers request estimated
    hash-table / sort-run bytes, so the weight IS the hash-table size):

        share = available * (requested * m) / (demand + requested * m)

    with ``m = hash_mem_multiplier``.  Memory-hungry hash builds are favored
    by ``m`` exactly as PG lets hash tables exceed ``work_mem`` by that
    factor — their spill amplification is superlinear in the deficit, so a
    byte given to the biggest deficit saves the most temp I/O.  Unlike the
    floor policy this trades pool liquidity for deficit reduction; fig11's
    floor rationale still holds for bimodal workloads, which is why floor
    stays the default and this policy is opt-in
    (``MemoryGovernor(policy="proportional")``).
    """

    name = "proportional"

    def __init__(self, hash_mem_multiplier: float = 2.0):
        if hash_mem_multiplier <= 0:
            raise ValueError(
                f"hash_mem_multiplier must be positive, got "
                f"{hash_mem_multiplier}")
        self.hash_mem_multiplier = float(hash_mem_multiplier)

    def degraded_size(self, requested, available, floor, demand_bytes):
        weighted = requested * self.hash_mem_multiplier
        share = int(available * weighted / max(1.0, demand_bytes + weighted))
        return max(floor, share)


def _resolve_policy(policy: Union[str, GrantPolicy, None]) -> GrantPolicy:
    if policy is None or policy == "floor":
        return FloorGrantPolicy()
    if policy == "proportional":
        return ProportionalShareGrantPolicy()
    if isinstance(policy, GrantPolicy):
        return policy
    raise ValueError(f"unknown grant policy {policy!r}; expected 'floor', "
                     f"'proportional', or a GrantPolicy instance")


@dataclasses.dataclass
class GovernorStats:
    """Cumulative counters; snapshot via :meth:`MemoryGovernor.stats`."""

    grants: int = 0            # grants issued
    degraded: int = 0          # grants smaller than their request
    waits: int = 0             # requests that blocked in admission control
    wait_s_total: float = 0.0  # total seconds spent blocked
    peak_in_use: int = 0       # high-water mark of committed bytes (granted + held)
    over_budget_events: int = 0  # invariant violations (must stay 0)
    holds: int = 0             # price-and-hold reservations placed
    holds_converted: int = 0   # holds that became grants
    holds_expired: int = 0     # holds reaped at TTL expiry
    holds_cancelled: int = 0   # holds explicitly released unconverted


@dataclasses.dataclass
class MemoryGrant:
    """An outstanding slice of the governor's budget.

    ``size`` is the work_mem the holding operator must live within; ``size <
    requested`` marks a degraded grant.  Use as a context manager (exit
    releases if still held) or call :meth:`release` exactly once — a second
    explicit release raises instead of silently corrupting the budget
    accounting (a double ``_release`` would inflate the available pool and
    let the governor over-grant its budget).
    """

    governor: "MemoryGovernor"
    size: int
    requested: int
    wait_s: float = 0.0
    _released: bool = False

    @property
    def degraded(self) -> bool:
        return self.size < self.requested

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if self._released:
            raise BrokerInvariantViolation(
                f"memory grant of {self.size} B released twice; a silent "
                f"double release would inflate the available budget")
        self._released = True
        self.governor._release(self.size, self.requested)

    def __enter__(self) -> "MemoryGrant":
        return self

    def __exit__(self, *exc) -> None:
        if not self._released:
            self.release()


@dataclasses.dataclass
class TieredGrant(MemoryGrant):
    """A :class:`MemoryGrant` extended with per-tier spill quotas.

    ``quotas`` maps tier name (``"t0"``/``"t1"``/``"t2"``) to the byte
    quota this operator may place there (``None`` = only the tier's own
    capacity caps it).  Issued instead of a plain grant whenever the
    governor has a spill-tier hierarchy attached
    (``MemoryGovernor(tiers=...)``); sizing comes from
    :meth:`GrantPolicy.tier_quotas`.  Release semantics are unchanged —
    quotas are advisory caps the :class:`~repro_torch.core.tier.TierManager`
    enforces, not budget the governor tracks (the T0 pool's bytes are
    bounded BY the quota, which is itself derived from the granted size).
    """

    quotas: Dict[str, Optional[int]] = dataclasses.field(default_factory=dict)


class MemoryHold:
    """A short-TTL commitment of budget bytes placed at decision time.

    The price-and-hold half of a reservation: ``size`` bytes are counted
    against the budget (``in_use + held <= total``) from placement until the
    hold **converts** into a grant (``MemoryGovernor.acquire(...,
    hold=...)``), is **cancelled** (the decision chose the tensor path), or
    **expires** at ``deadline`` (the TTL backstop: a crashed or stalled
    decision can never strand budget).  Exactly one of those three outcomes
    occurs — the leak test asserts ``holds == converted + expired +
    cancelled`` and ``held_bytes == 0`` at quiesce.
    """

    __slots__ = ("governor", "size", "requested", "deadline", "state")

    def __init__(self, governor: "MemoryGovernor", size: int, requested: int,
                 deadline: float):
        self.governor = governor
        self.size = size
        self.requested = requested
        self.deadline = deadline
        self.state = "held"  # held | converted | expired | cancelled

    @property
    def active(self) -> bool:
        """True while the hold still pins budget (reaps expiry first)."""
        self.governor._reap_holds()
        return self.state == "held"

    def cancel(self) -> None:
        """Release the hold unconverted.  Idempotent; a no-op once the hold
        has converted or expired."""
        self.governor._cancel_hold(self)

    def __enter__(self) -> "MemoryHold":
        return self

    def __exit__(self, *exc) -> None:
        self.cancel()


class MemoryGovernor:
    """Thread-safe admission controller over one total memory budget."""

    def __init__(self, total_bytes: int, min_grant: int = 1 * MB,
                 full_grant_wait_s: float = 0.0,
                 policy: Union[str, GrantPolicy, None] = None,
                 tiers=None):
        if total_bytes <= 0:
            raise ValueError(f"total_bytes must be positive, got {total_bytes}")
        min_grant = max(1, int(min_grant))
        if min_grant > total_bytes:
            raise ValueError(
                f"min_grant ({min_grant} B) exceeds the total budget "
                f"({total_bytes} B); no request could ever be admitted")
        self.total_bytes = int(total_bytes)
        self.min_grant = min_grant
        # how long a request is willing to wait for its FULL size before
        # accepting a degraded grant (0 = degrade immediately; degrading
        # early trades per-query latency for throughput, like PG choosing a
        # smaller hash table over queueing the whole backend)
        self.full_grant_wait_s = float(full_grant_wait_s)
        self.policy = _resolve_policy(policy)
        # optional spill-tier hierarchy (a TierConfig-shaped object): when
        # set, every grant is a TieredGrant carrying per-tier spill quotas
        self.tiers = tiers
        self._in_use = 0
        self._held = 0            # bytes committed to unexpired holds
        self._holds: list = []    # active MemoryHold objects
        self._demand = 0          # sum of REQUESTED bytes, outstanding grants
        self._waiters = 0         # requests parked in admission control
        self._waiting_demand = 0  # sum of their requested bytes
        self._cond = threading.Condition()
        self._stats = GovernorStats()

    # -- observability -------------------------------------------------------
    @property
    def in_use(self) -> int:
        return self._in_use

    @property
    def held_bytes(self) -> int:
        """Bytes committed to active (unexpired) holds."""
        self._reap_holds()
        with self._cond:
            return self._held

    @property
    def available(self) -> int:
        return self.total_bytes - self._in_use - self._held

    @property
    def waiters(self) -> int:
        """Requests currently parked in admission control."""
        return self._waiters

    @property
    def pressure(self) -> float:
        """Fraction of the budget currently granted (0.0 = idle, 1.0 = full)."""
        return self._in_use / self.total_bytes

    def stats(self) -> GovernorStats:
        self._reap_holds()
        with self._cond:
            return dataclasses.replace(self._stats)

    # -- hold bookkeeping (price-and-hold reservations) ----------------------
    def _reap_locked(self, now: float) -> None:
        """Expire past-deadline holds (lock held).  Lazy: runs on every lock
        acquisition; admission waits are additionally bounded by the nearest
        hold deadline so expiry also wakes parked waiters promptly."""
        if not self._holds:
            return
        freed = 0
        live = []
        for h in self._holds:
            if h.state == "held" and now >= h.deadline:
                h.state = "expired"
                freed += h.size
                self._stats.holds_expired += 1
            elif h.state == "held":
                live.append(h)
        if freed:
            self._holds[:] = live
            self._held -= freed
            self._cond.notify_all()

    def _reap_holds(self) -> None:
        with self._cond:
            self._reap_locked(time.perf_counter())

    def _next_hold_deadline_locked(self):
        return min((h.deadline for h in self._holds if h.state == "held"),
                   default=None)

    def hold(self, requested: int, ttl_s: float = 0.25
             ) -> Optional["MemoryHold"]:
        """Commit the bytes :meth:`acquire` would grant right now, for at
        most ``ttl_s`` seconds.  Returns ``None`` when acquisition would
        *block* (not even the floor is free): there is nothing truthful to
        hold, and the quote already says "you will wait".  Never blocks."""
        requested = max(1, int(requested))
        floor = min(requested, self.min_grant)
        now = time.perf_counter()
        with self._cond:
            self._reap_locked(now)
            avail = self.total_bytes - self._in_use - self._held
            if avail < floor or self._waiters > 0:
                # parked waiters have admission priority over new decisions:
                # holding bytes past them would starve admission control
                return None
            size = self._size_for(requested, avail, floor)
            h = MemoryHold(self, size, requested, now + float(ttl_s))
            self._holds.append(h)
            self._held += size
            self._stats.holds += 1
            self._stats.peak_in_use = max(self._stats.peak_in_use,
                                          self._in_use + self._held)
            if self._in_use + self._held > self.total_bytes:  # pragma: no cover
                self._stats.over_budget_events += 1
            return h

    def _cancel_hold(self, h: "MemoryHold") -> None:
        with self._cond:
            self._reap_locked(time.perf_counter())
            if h.state != "held":
                return  # converted/expired/already cancelled: idempotent
            h.state = "cancelled"
            self._holds.remove(h)
            self._held -= h.size
            self._stats.holds_cancelled += 1
            self._cond.notify_all()

    def _size_for(self, requested: int, avail: int, floor: int) -> int:
        """Grant sizing (lock held): full if it fits, else the policy's
        degraded size clamped into [floor, min(requested, avail)] — the
        clamp, not the policy, owns the never-over-budget invariant.
        Callers are never in the waiting set at sizing time (acquire runs
        ``end_wait`` first), so the demand picture excludes this request
        by construction."""
        if avail >= requested:
            return requested
        demand = self._demand + self._waiting_demand
        size = int(self.policy.degraded_size(requested, avail, floor,
                                             max(0, demand)))
        return max(floor, min(size, requested, max(floor, avail)))

    def would_grant(self, requested: int) -> int:
        """Non-binding peek: the grant size a request of ``requested`` bytes
        would receive right now.  Mirrors :meth:`acquire`'s sizing exactly
        (a signal reporting a size the grant will never contain would price
        the linear path against phantom memory); it does NOT model admission
        blocking — :meth:`admission_probe` adds the would-block/waiters
        picture and :meth:`~repro_torch.core.resource_broker.ResourceBroker.price`
        turns that into an expected wait."""
        return self.admission_probe(requested)[0]

    def admission_probe(self, requested: int):
        """``(size, would_block, waiters)`` — the wait-aware pressure peek.

        ``size`` is :meth:`would_grant`'s answer; ``would_block`` reports
        whether :meth:`acquire` would park in admission control right now
        (not even the floor is free); ``waiters`` how many requests are
        already parked ahead.  Lock-held reads only; never blocks, never
        reserves."""
        requested = max(1, int(requested))
        floor = min(requested, self.min_grant)
        with self._cond:
            self._reap_locked(time.perf_counter())
            avail = self.total_bytes - self._in_use - self._held
            size = self._size_for(requested, avail, floor)
            return size, avail < floor, self._waiters

    # -- grant lifecycle -----------------------------------------------------
    def _make_grant(self, size: int, requested: int,
                    wait_s: float) -> MemoryGrant:
        if self.tiers is None:
            return MemoryGrant(self, size, requested, wait_s)
        quotas = self.policy.tier_quotas(size, requested, self.tiers)
        return TieredGrant(self, size, requested, wait_s, quotas=quotas)

    def acquire(self, requested: int, timeout: Optional[float] = None,
                hold: Optional["MemoryHold"] = None) -> MemoryGrant:
        """Block until at least ``min(requested, min_grant)`` bytes are free,
        then grant the policy's sizing (full when it fits).

        With ``full_grant_wait_s > 0`` the request first waits up to that
        long for its *full* size before settling for a degraded grant.
        ``timeout`` bounds the total admission wait; expiry raises
        :class:`TimeoutError` (the caller's query fails rather than wedging
        a worker forever — surfaced, never silent).

        ``hold`` converts a still-active :class:`MemoryHold` placed by
        :meth:`hold` into the grant *without waiting*: the bytes were
        committed at decision time, which is exactly the decide-then-lose
        guarantee.  An expired or cancelled hold falls through to the normal
        admission path (the quote's promise lapsed; the request competes
        like everyone else).
        """
        requested = max(1, int(requested))
        floor = min(requested, self.min_grant)
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._cond:
            self._reap_locked(t0)
            if hold is not None and hold.state == "held":
                # conversion: committed bytes move from held to granted —
                # no admission wait, no sizing (priced at hold time)
                hold.state = "converted"
                self._holds.remove(hold)
                self._held -= hold.size
                self._in_use += hold.size
                self._demand += hold.requested
                self._stats.holds_converted += 1
                self._stats.grants += 1
                if hold.size < hold.requested:
                    self._stats.degraded += 1
                self._stats.peak_in_use = max(self._stats.peak_in_use,
                                              self._in_use + self._held)
                if self._in_use + self._held > self.total_bytes:  # pragma: no cover
                    self._stats.over_budget_events += 1
                return self._make_grant(hold.size, hold.requested, 0.0)
            waited = False

            def begin_wait():
                nonlocal waited
                if not waited:
                    waited = True
                    self._waiters += 1
                    self._waiting_demand += requested

            def end_wait():
                if waited:
                    self._waiters -= 1
                    self._waiting_demand -= requested

            def avail():
                return self.total_bytes - self._in_use - self._held

            def wait_bounded(remaining):
                # bound every park by the nearest hold deadline: a waiter
                # blocked only by an expiring hold must wake when it lapses
                nd = self._next_hold_deadline_locked()
                if nd is not None:
                    until_expiry = max(1e-3, nd - time.perf_counter())
                    remaining = (until_expiry if remaining is None
                                 else min(remaining, until_expiry))
                self._cond.wait(remaining)
                self._reap_locked(time.perf_counter())

            try:
                # phase 1: opportunistic wait for the full request
                if self.full_grant_wait_s > 0:
                    full_deadline = t0 + self.full_grant_wait_s
                    if deadline is not None:
                        full_deadline = min(full_deadline, deadline)
                    while (avail() < requested
                           and time.perf_counter() < full_deadline):
                        begin_wait()
                        wait_bounded(full_deadline - time.perf_counter())
                # phase 2: admission control — never grant below the floor
                while avail() < floor:
                    begin_wait()
                    remaining = (None if deadline is None
                                 else deadline - time.perf_counter())
                    if remaining is not None and remaining <= 0:
                        self._stats.waits += 1
                        self._stats.wait_s_total += time.perf_counter() - t0
                        raise TimeoutError(
                            f"admission control: {requested} B requested, "
                            f"{avail()} B available after {timeout:.3f}s")
                    wait_bounded(remaining)
            finally:
                end_wait()
            size = self._size_for(requested, avail(), floor)
            self._in_use += size
            self._demand += requested
            if self._in_use + self._held > self.total_bytes:  # pragma: no cover
                self._stats.over_budget_events += 1
            self._stats.grants += 1
            if size < requested:
                self._stats.degraded += 1
            if waited:
                self._stats.waits += 1
                self._stats.wait_s_total += time.perf_counter() - t0
            self._stats.peak_in_use = max(self._stats.peak_in_use,
                                          self._in_use + self._held)
            wait_s = time.perf_counter() - t0 if waited else 0.0
        return self._make_grant(size, requested, wait_s)

    def _release(self, size: int, requested: int) -> None:
        with self._cond:
            self._in_use -= size
            self._demand -= requested
            if self._in_use < 0:  # pragma: no cover - accounting corruption
                self._stats.over_budget_events += 1
                self._in_use = 0
            if self._demand < 0:  # pragma: no cover
                self._demand = 0
            self._cond.notify_all()
