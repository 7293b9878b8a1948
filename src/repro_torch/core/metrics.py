"""Execution metrics: latency percentiles, spill accounting, working-set peaks.

The paper evaluates three families of metrics together (abstract, §V):
  * latency distribution — P50 *and* P99 (+max), because the phenomenon under
    study is predictability loss, not mean slowdown;
  * physical I/O — Temp_MB and 8 KB block counts (PostgreSQL-style);
  * peak working set of the linearized intermediate (hash table / sort runs).

Beside them, :func:`span` records where one query's time goes, layer by
layer, as nested spans on the host clock (off unless asked for; see
:func:`start_spans`).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np

BLOCK_BYTES = 8192  # PostgreSQL temp-file block size; paper reports 25,662 blocks ≈ 200 MB

__all__ = ["BLOCK_BYTES", "SpillAccount", "OpMetrics", "LatencyStats",
           "latency_stats", "Timer", "Span", "span", "start_spans",
           "stop_spans", "spans_on"]


@dataclasses.dataclass
class SpillAccount:
    """Temp-file I/O accounting for one operator execution."""

    bytes_written: int = 0
    bytes_read: int = 0
    # Bytes of temp space released back (partition/run deletion).  Live
    # occupancy — what tier capacity enforcement actually cares about — is
    # ``live_bytes = written - freed``; ``bytes_written`` alone only ever
    # grows and overstates footprint by the whole recursion history.
    bytes_freed: int = 0
    files_created: int = 0
    partition_passes: int = 0  # recursive partitioning / merge passes
    # High-water mark of live temp occupancy, maintained by write()/free().
    peak_live_bytes: int = 0

    def write(self, nbytes: int) -> None:
        self.bytes_written += int(nbytes)
        if self.live_bytes > self.peak_live_bytes:
            self.peak_live_bytes = self.live_bytes

    def read(self, nbytes: int) -> None:
        self.bytes_read += int(nbytes)

    def free(self, nbytes: int) -> None:
        self.bytes_freed += int(nbytes)

    @property
    def live_bytes(self) -> int:
        """Temp bytes written and not yet deleted (true current occupancy)."""
        return max(0, self.bytes_written - self.bytes_freed)

    @property
    def temp_bytes(self) -> int:
        return self.bytes_written

    @property
    def temp_mb(self) -> float:
        return self.bytes_written / 1e6

    @property
    def blocks(self) -> int:
        return -(-self.bytes_written // BLOCK_BYTES)

    def merge(self, other: "SpillAccount") -> None:
        self.bytes_written += other.bytes_written
        self.bytes_read += other.bytes_read
        self.bytes_freed += other.bytes_freed
        self.files_created += other.files_created
        self.partition_passes = max(self.partition_passes, other.partition_passes)
        # conservative: peaks of sequential operators never overlapped, so
        # the merged peak is the max, not the sum
        self.peak_live_bytes = max(self.peak_live_bytes, other.peak_live_bytes)


@dataclasses.dataclass
class OpMetrics:
    """Metrics for a single operator execution."""

    op: str
    path: str  # "linear" | "tensor"
    rows_in: int
    rows_out: int
    wall_s: float
    spill: SpillAccount
    peak_working_set_bytes: int = 0
    decision_reason: str = ""
    # Device→host synchronization events for this operator (a transfer of
    # results or a blocking scalar read such as a match count).  The linear
    # path is host-native and reports 0; the per-operator tensor path pays
    # 1-2 per operator; the fused device-resident path pays 1 per *query*.
    host_syncs: int = 0
    # Host→device bytes actually transferred for this operator's inputs —
    # PHYSICAL bytes: with packed device layouts (core/codec_device) this is
    # the codes + dictionaries that really crossed the bus, not the logical
    # column width.  Warm queries over device-cached base tables report 0 —
    # the serving-path contract the fig9 benchmark measures (and packed
    # residency keeps satisfying: a resident column in either form is warm).
    h2d_bytes: int = 0
    # The same transfers priced at LOGICAL column width — what the upload
    # would have cost without packed layouts.  physical/logical is the
    # per-operator compression ratio fig17 reports; 0 when nothing moved.
    h2d_bytes_logical: int = 0
    # Memory grant this linear operator ran under (0 when ungoverned or on
    # the tensor path).  Under a shared MemoryGovernor this is the budget
    # slice actually received — smaller than the configured work_mem when
    # concurrent queries contend, which is what pushes the operator into
    # the spill regime fig11 measures.  ``grant_degraded`` marks a grant
    # smaller than its request: the operator's wall then reflects
    # contention-induced spilling, not the operator's full-memory cost,
    # and is excluded from runtime-profile feedback (load is admission's
    # problem; the profile models cost).
    grant_bytes: int = 0
    grant_degraded: bool = False
    # Seconds this operator spent queued for its device lease (concurrent
    # serving: device dispatch is admitted through the broker's DeviceQueue;
    # the fused pipeline AND the per-operator tensor path both hold a lease).
    # Included in wall_s — it IS end-to-end latency — but excluded from the
    # runtime-profile feedback, which models execution cost, not load.
    queue_wait_s: float = 0.0
    # Seconds this linear operator spent blocked in memory admission control
    # before its grant was issued (0 when ungoverned or on the tensor path).
    # NOT part of wall_s: the operator's timer starts after admission, so
    # admission wait never pollutes runtime-profile feedback; end-to-end
    # latency including it is the serving layer's per-query timer.
    mem_wait_s: float = 0.0
    # True when this operator's device dispatch was admitted as part of a
    # coalesced (micro-batched) lease group — several queued dispatches of
    # the same compiled shape ran as one admission round instead of
    # serially.  Scheduling only; results are bit-for-bit identical.
    batched: bool = False
    # True when this operator's run may have paid jit compilation (a fused
    # program cache miss, including a hit on a not-yet-ready entry).  The
    # executor's warm-feedback gate keys off THIS, not a global counter
    # delta — another thread's concurrent compile must not make a warm run
    # look cold.
    compiled: bool = False
    # True when this operator started on a floor-degraded LINEAR grant, was
    # preempted mid-spill by the broker, and re-ran (successfully) on the
    # tensor path — the metrics describe the tensor run that produced the
    # result; this flag records that a preemption paid for it.
    preempted: bool = False
    # Mesh devices this operator's dispatch spanned: 1 for the linear path
    # and the single-device tensor path, N for a partition-parallel fused
    # fragment (one broker lane per device; queue_wait_s then accumulates
    # the gang acquisition's blocked time across lanes).
    devices: int = 1
    # True when an ExecutionGuard abandoned this operator's first path
    # mid-query and the tensor path finished it (a SwitchPoint, distinct
    # from broker preemption: the operator itself decided its decision was
    # mispriced).  ``path`` then names the path that produced the result;
    # the abandoned attempt is described by the pre_switch_* fields.
    switched: bool = False
    # Wall seconds the abandoned pre-switch (or pre-preemption) attempt
    # burned before the switch point.  Included in wall_s so end-to-end
    # query accounting stays honest, but attributed to pre_switch_path —
    # never to the final path's runtime-profile cell.
    pre_switch_wall_s: float = 0.0
    pre_switch_path: str = ""
    # Logical bytes of already-spilled partitions the switch completion
    # read back through the spill/tier manager instead of rebuilding from
    # the base relations (the loss-free reuse the guard contract promises;
    # also counted in spill.bytes_read, so books stay balanced).
    reused_spill_bytes: int = 0

    def as_row(self) -> Dict[str, object]:
        return {
            "op": self.op,
            "path": self.path,
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "wall_s": round(self.wall_s, 6),
            "temp_mb": round(self.spill.temp_mb, 3),
            "temp_blocks": self.spill.blocks,
            # leftover live temp space after the operator finished — nonzero
            # means a partition/run file leaked past its pass
            "temp_live_mb": round(self.spill.live_bytes / 1e6, 3),
            "temp_peak_live_mb": round(self.spill.peak_live_bytes / 1e6, 3),
            "passes": self.spill.partition_passes,
            "peak_ws_mb": round(self.peak_working_set_bytes / 1e6, 3),
            "host_syncs": self.host_syncs,
            "h2d_mb": round(self.h2d_bytes / 1e6, 3),
            "h2d_logical_mb": round(self.h2d_bytes_logical / 1e6, 3),
            "grant_mb": round(self.grant_bytes / 1e6, 3),
            "devices": self.devices,
            "switched": self.switched,
            "reason": self.decision_reason,
        }


@dataclasses.dataclass
class LatencyStats:
    p50: float
    p95: float
    p99: float
    max: float
    mean: float
    n: int

    def as_row(self) -> Dict[str, float]:
        return {
            "p50_s": round(self.p50, 6),
            "p95_s": round(self.p95, 6),
            "p99_s": round(self.p99, 6),
            "max_s": round(self.max, 6),
            "mean_s": round(self.mean, 6),
            "n": self.n,
        }


def latency_stats(samples_s: List[float]) -> LatencyStats:
    a = np.asarray(samples_s, dtype=np.float64)
    return LatencyStats(
        p50=float(np.percentile(a, 50)),
        p95=float(np.percentile(a, 95)),
        p99=float(np.percentile(a, 99)),
        max=float(a.max()),
        mean=float(a.mean()),
        n=len(a),
    )


class Timer:
    """Wall-clock context manager."""

    def __enter__(self) -> "Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.t0


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
#
# Each layer of a query marks the work it does as a span: the query itself
# (``Session.execute``), its plan, each path decision, the upload and host
# planning before a launch, the wait for and the hold of each device lease,
# the launch, the fetch and its pinned buffer, and the host work that
# finishes the answer.  A span knows its parent (the span open on the same
# thread when it opened) and its query (the id of its outermost span), so
# the spans of concurrent queries stay apart.  Times are
# ``time.perf_counter_ns()``, the clock ``time.perf_counter`` reads.
#
# The recorder is on between :func:`start_spans` and :func:`stop_spans`,
# and while a ``torch.profiler`` session records in the process, so that a
# profiled period carries the program's own spans; :func:`stop_spans` hands
# over what was recorded either way.  Off, a span site costs two attribute
# reads and returns the shared :data:`NO_SPAN`, which is false, so a site
# can skip counting what only a span would carry.

try:
    from torch.autograd import profiler as _profiler

    _profiler._is_profiler_enabled
except (ImportError, AttributeError):  # a torch without the flag
    class _profiler:  # noqa: N801
        _is_profiler_enabled = False

_on = False
_done: List["Span"] = []
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One step of a query: ``name``, ``query`` (the id shared by every span
    of one query), ``id``, ``parent`` (an id, None at a query's root),
    ``thread`` (``threading.get_native_id()``), ``t0_ns`` and ``t1_ns``
    (``time.perf_counter_ns()``) and ``attrs``, a small dict of counts.

    Use it as a context manager, or :meth:`close` it where the work ends.
    A span that raised gets ``attrs["error"]``, the exception's class name."""

    __slots__ = ("name", "query", "id", "parent", "thread", "t0_ns", "t1_ns",
                 "attrs", "_stack")

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def close(self, t1_ns: Optional[int] = None) -> "Span":
        """End the span now (or at ``t1_ns``).  Spans opened inside it and
        left open, by an exception, end with it."""
        if self.t1_ns is not None:
            return self
        self.t1_ns = time.perf_counter_ns() if t1_ns is None else t1_ns
        stack = self._stack
        if any(s is self for s in stack):
            while True:
                top = stack.pop()
                if top is self:
                    break
                if top.t1_ns is None:
                    top.t1_ns = self.t1_ns
                    _done.append(top)
        _done.append(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.close()


class _NoSpan:
    """What a span site returns while the recorder is off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, key: str, value) -> "_NoSpan":
        return self

    def close(self, t1_ns: Optional[int] = None) -> "_NoSpan":
        return self

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NO_SPAN = _NoSpan()


def spans_on() -> bool:
    """Whether span sites record now."""
    return _on or _profiler._is_profiler_enabled


def span(name: str, t0_ns: Optional[int] = None):
    """Open span ``name`` on this thread, from now or from ``t0_ns``: a
    child of the span open on this thread, or the root of a new query.
    Returns :data:`NO_SPAN` while the recorder is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return NO_SPAN
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    s = Span()
    s.id = next(_ids)
    if stack:
        s.parent, s.query = stack[-1].id, stack[-1].query
    else:
        s.parent, s.query = None, s.id
    s.name = name
    s.thread = threading.get_native_id()
    s.t0_ns = time.perf_counter_ns() if t0_ns is None else t0_ns
    s.t1_ns = None
    s.attrs = {}
    s._stack = stack
    stack.append(s)
    return s


def start_spans() -> None:
    """Turn the recorder on, with nothing recorded yet."""
    global _on, _done
    _done = []
    _on = True


def stop_spans() -> List[Span]:
    """Turn the recorder off and hand over every span closed since
    :func:`start_spans` (or since the last call), in the order they
    closed."""
    global _on, _done
    _on = False
    out, _done = _done, []
    return out
