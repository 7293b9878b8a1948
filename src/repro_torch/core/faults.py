"""Fault injection, the typed serving-error taxonomy, and retry policy.

The serving layer's robustness claims (open-loop SLO serving, fig13's chaos
gate) are only claims if the failure modes can be *produced on demand*.
This module is the single switchboard for that:

  * a typed **error taxonomy** — :class:`QueryRejected` (admission-control
    load shedding), :class:`DeadlineExceeded` (an admitted query missed its
    SLO deadline), and :class:`TransientError` (retryable infrastructure
    faults: :class:`SpillIOError`, :class:`DeviceDispatchError`,
    :class:`GrantTimeout`) — so the serving layer can *classify* every
    failure instead of aborting a whole run on the first worker exception;
  * a seeded, thread-safe :class:`FaultInjector` with one hook per
    infrastructure fault site: spill-file writes (transient I/O errors and
    simulated mid-write crashes), device dispatch (failures and slowdowns),
    and memory-grant acquisition (forced admission timeouts).  Injection is
    probabilistic per site with an independent deterministic RNG, so a
    seeded chaos run replays the same fault schedule;
  * a :class:`RetryPolicy` — exponential backoff with full jitter, the
    classic thundering-herd-safe retry discipline — that the executor
    applies to :class:`TransientError` only.  Repeated *device* failures
    additionally trigger **path fallback**: the executor pins the failing
    query onto the linear path, trading speed for completion (the device
    being sick must degrade service, not abort it).

:class:`PreemptedError` is control flow, not a failure: it is how a
floor-degraded linear operator abandons its spill mid-flight when the
broker preempts it, and the executor requeues the operator on the tensor
path (see ``docs/serving.md``).  :class:`SimulatedCrash` deliberately
derives from ``BaseException``: it models a *killed* worker, and ordinary
``except Exception`` cleanup handlers must not get a chance to tidy up
state a real death would have left behind (the crash-consistent spill
finalize test depends on exactly this).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

__all__ = [
    "QueryRejected", "DeadlineExceeded", "TransientError", "SpillIOError",
    "SpillCorruptionError", "DeviceDispatchError", "GrantTimeout",
    "PreemptedError", "SimulatedCrash", "RetryPolicy", "FaultInjector",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class QueryRejected(Exception):
    """Admission control shed this query: its quoted wait already exceeded
    its deadline, so running it would only burn capacity on a result nobody
    can use.  Recorded as a *shed* sample, never a failure."""


class DeadlineExceeded(Exception):
    """An admitted query missed its SLO deadline while queued (admission let
    it through, then load grew).  Recorded as a *failed* sample — distinct
    from shedding, because it represents an admission mistake."""


class TransientError(Exception):
    """A retryable infrastructure fault.  The executor retries these with
    exponential backoff + jitter; anything else propagates immediately."""


class SpillIOError(TransientError, OSError):
    """A spill-file read or write failed transiently (injected or real EIO)."""


class SpillCorruptionError(TransientError):
    """A spilled column failed its CRC32 check on read — a torn or
    bit-flipped tier-1/2 file.  Typed (never silently wrong rows), and
    transient on purpose: a corrupt TEMP file is recoverable — a tiered read
    fails over to the next copy down the hierarchy, and a whole-operator
    retry simply re-spills."""


class DeviceDispatchError(TransientError):
    """A device dispatch failed transiently.  Repeated occurrences trigger
    path fallback: the executor pins the query onto the linear path."""


class GrantTimeout(TransientError, TimeoutError):
    """A memory-grant acquisition timed out in admission control.  Also a
    ``TimeoutError`` so callers that already handle governor timeouts keep
    working unchanged."""


class PreemptedError(Exception):
    """A floor-degraded linear operator was preempted mid-spill.  Control
    flow, not a failure: the executor catches it and requeues the operator
    on the tensor path."""


class SimulatedCrash(BaseException):
    """A fault-injected worker death (SIGKILL analogue).  BaseException on
    purpose: ``except Exception`` cleanup paths must not run — a killed
    process would not have run them either, which is the whole point of
    testing crash consistency."""


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff with full jitter for :class:`TransientError`.

    ``backoff(attempt)`` for attempt 1, 2, ... draws uniformly from
    ``[0, min(cap_s, base_s * 2**(attempt-1))]`` — full jitter, the variant
    that de-synchronizes retry storms best (all-jitter beats equal-jitter
    when many workers fail together, which is exactly the injected-fault
    case).  ``device_fallback_after`` is the path-fallback threshold: that
    many device-dispatch failures within one query pins the query linear.
    Seeded so a chaos run's backoff schedule replays.
    """

    def __init__(self, max_attempts: int = 4, base_s: float = 0.01,
                 cap_s: float = 0.25, device_fallback_after: int = 2,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.device_fallback_after = int(device_fallback_after)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        ceiling = min(self.cap_s, self.base_s * (2 ** max(0, attempt - 1)))
        with self._lock:
            return self._rng.uniform(0.0, ceiling)


# ---------------------------------------------------------------------------
# Fault injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Deterministic, thread-safe fault switchboard.

    One hook per infrastructure fault site; each site rolls an independent
    seeded RNG so enabling one fault class never perturbs another's
    schedule (and a fixed seed replays the same chaos run):

      * :meth:`on_spill_column` — called before every spill column write;
        raises :class:`SpillIOError` with probability ``spill_io_p``, or
        :class:`SimulatedCrash` when a one-shot kill armed via
        :meth:`arm_spill_kill` counts down to zero (the crash-consistency
        regression);
      * :meth:`on_device_dispatch` — called on device-lease acquisition;
        sleeps ``device_slow_s`` with probability ``device_slow_p`` (a slow
        device is survivable and must NOT error), and raises
        :class:`DeviceDispatchError` with probability ``device_fail_p``;
      * :meth:`on_memory_grant` — called on memory-lease acquisition;
        raises :class:`GrantTimeout` with probability ``grant_timeout_p``;
      * :meth:`on_spill_read` — called before every spill column read on an
        I/O-backed tier; raises :class:`SpillIOError` with probability
        ``spill_read_p`` (the tiered read path fails over down the
        hierarchy);
      * :meth:`on_remote_read` — emulated remote-tier slowdown: sleeps
        ``remote_slow_s`` with probability ``remote_slow_p``.

    ``counts()`` reports how many faults each site actually injected — the
    chaos gate asserts they are nonzero, so "survived chaos" can never mean
    "chaos never happened".
    """

    def __init__(self, seed: int = 0, spill_io_p: float = 0.0,
                 device_fail_p: float = 0.0, device_slow_p: float = 0.0,
                 device_slow_s: float = 0.02, grant_timeout_p: float = 0.0,
                 spill_read_p: float = 0.0, remote_slow_p: float = 0.0,
                 remote_slow_s: float = 0.01):
        for name, p in (("spill_io_p", spill_io_p),
                        ("device_fail_p", device_fail_p),
                        ("device_slow_p", device_slow_p),
                        ("grant_timeout_p", grant_timeout_p),
                        ("spill_read_p", spill_read_p),
                        ("remote_slow_p", remote_slow_p)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.spill_io_p = float(spill_io_p)
        self.device_fail_p = float(device_fail_p)
        self.device_slow_p = float(device_slow_p)
        self.device_slow_s = float(device_slow_s)
        self.grant_timeout_p = float(grant_timeout_p)
        self.spill_read_p = float(spill_read_p)
        self.remote_slow_p = float(remote_slow_p)
        self.remote_slow_s = float(remote_slow_s)
        self._lock = threading.Lock()
        self._rngs = {site: random.Random((seed, site).__hash__() & 0x7FFFFFFF)
                      for site in ("spill_io", "device_fail", "device_slow",
                                   "grant_timeout", "spill_read",
                                   "remote_slow")}
        self._counts: Dict[str, int] = {
            "spill_io": 0, "spill_kill": 0, "device_fail": 0,
            "device_slow": 0, "grant_timeout": 0, "spill_read": 0,
            "remote_slow": 0}
        self._kill_countdown: Optional[int] = None

    def _roll(self, site: str, p: float) -> bool:
        if p <= 0.0:
            return False
        with self._lock:
            if self._rngs[site].random() < p:
                self._counts[site] += 1
                return True
        return False

    # -- arming ---------------------------------------------------------------
    def arm_spill_kill(self, after_columns: int = 1) -> None:
        """One-shot: the ``after_columns``-th subsequent spill column write
        dies with :class:`SimulatedCrash` (then disarms)."""
        if after_columns < 1:
            raise ValueError(f"after_columns must be >= 1, got {after_columns}")
        with self._lock:
            self._kill_countdown = int(after_columns)

    # -- fault sites ----------------------------------------------------------
    def on_spill_column(self, path: str = "") -> None:
        with self._lock:
            if self._kill_countdown is not None:
                self._kill_countdown -= 1
                if self._kill_countdown <= 0:
                    self._kill_countdown = None
                    self._counts["spill_kill"] += 1
                    raise SimulatedCrash(
                        f"injected worker death mid-spill at {path!r}")
        if self._roll("spill_io", self.spill_io_p):
            raise SpillIOError(f"injected spill I/O error at {path!r}")

    def on_device_dispatch(self) -> None:
        if self._roll("device_slow", self.device_slow_p):
            time.sleep(self.device_slow_s)
        if self._roll("device_fail", self.device_fail_p):
            raise DeviceDispatchError("injected device dispatch failure")

    def on_memory_grant(self) -> None:
        if self._roll("grant_timeout", self.grant_timeout_p):
            raise GrantTimeout("injected memory-grant admission timeout")

    def on_spill_read(self, path: str = "") -> None:
        """Called before every spill column *read* on an I/O-backed tier
        (disk / emulated remote); raises :class:`SpillIOError` with
        probability ``spill_read_p``.  The tiered read path catches this,
        retries per :class:`RetryPolicy`, and fails over down the hierarchy
        to the next resident copy."""
        if self._roll("spill_read", self.spill_read_p):
            raise SpillIOError(f"injected spill read error at {path!r}")

    def on_remote_read(self, nbytes: int = 0) -> None:
        """Called on emulated remote-tier (T1) transfers; sleeps
        ``remote_slow_s`` with probability ``remote_slow_p`` (a slow remote
        is survivable and must NOT error — it just makes the tier's priced
        latency show up in the tail)."""
        if self._roll("remote_slow", self.remote_slow_p):
            time.sleep(self.remote_slow_s)

    # -- observability --------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self._counts.values())
