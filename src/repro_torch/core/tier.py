"""Tiered spill hierarchy: the paper's binary spill cliff as a priced staircase.

The serving layer reproduced the cliff: a degraded grant means
partition-and-spill straight to local disk, and fig11 measures the
resulting ~30× P99/P50 phase transition.  REMOP's argument (PAPERS.md) is that operators should
price memory *tiers* rather than one budget, and Szépkúti's results show
compressed layouts beat raw ones at scale.  This module turns the cliff
into that staircase:

  * **T0 — compressed host RAM.**  A capacity-capped in-memory buffer pool
    holding dictionary-encoded + bit-packed columns (:func:`encode_column`).
    Spilling here costs a codec pass, not an fsync.
  * **T1 — emulated remote/slow tier.**  An in-memory store behind a
    deterministic, seeded per-byte latency + bandwidth cap — the model of a
    disaggregated-memory or network-attached spill target.
  * **T2 — local disk.**  The existing crash-consistent
    :class:`~repro_torch.core.spill.SpillManager`, unchanged.

:class:`TierManager` owns the ordered hierarchy behind the same
``write_relation`` / ``read_relation`` / ``open_run_reader`` / ``delete``
interface as ``SpillManager``, so ``linear_engine``'s Grace-join and
external-sort loops route through tiers without rewriting their pass
structure.  Writes land in the highest tier with room (capped by the
operator's :class:`~repro_torch.core.memory_governor.TieredGrant` quota); demand
reads fail over DOWN the hierarchy on injected I/O faults or CRC
corruption (retried per :class:`~repro_torch.core.faults.RetryPolicy`); an async
prefetcher streams spilled build partitions back UP (T2→T0) while the
probe side is still being consumed, overlapping re-read latency with join
compute.

Every tier keeps exact byte accounting (:class:`TierStats`); a
session-lifetime :class:`TierLedger` aggregates per-query managers so the
fig16 gate can assert the books balance — per tier, freed == written,
live == 0, and a drained pool at quiesce.
"""
from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .faults import (FaultInjector, RetryPolicy, SimulatedCrash,
                     SpillCorruptionError, TransientError)
from .metrics import SpillAccount
from .relation import Relation
from .spill import SpillManager, column_crc32

__all__ = [
    "TierConfig", "TierStats", "TierLedger", "TierManager",
    "EncodedColumn", "encode_column", "decode_column",
]

MB = 1 << 20
TIER_NAMES = ("t0", "t1", "t2")


# ---------------------------------------------------------------------------
# Compressed-tier codec: dictionary encoding + bit packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodedColumn:
    """One column, losslessly encoded for the compressed RAM tier.

    ``kind`` is one of:
      * ``"dict"`` — dictionary of unique *bit patterns* (so float NaN
        payloads and negative ints round-trip exactly) + bit-packed codes;
      * ``"pack"`` — frame-of-reference: minimum subtracted in wrapping
        uint64 arithmetic, deltas bit-packed (integer columns whose range
        is narrow but cardinality is high);
      * ``"raw"`` — verbatim copy (incompressible data, non-1-D arrays,
        exotic dtypes).

    ``crc`` is the CRC32 of the ORIGINAL bytes; :func:`decode_column`
    re-verifies it, so a bit flip inside the pool surfaces as a typed
    :class:`~repro_torch.core.faults.SpillCorruptionError`, never silent rows.
    """

    kind: str
    dtype: np.dtype
    n: int
    width: int                      # bits per packed code (dict/pack)
    base: int                       # frame-of-reference minimum (pack)
    payload: Tuple[np.ndarray, ...]
    crc: int

    @property
    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.payload)


def _bitpack(codes: np.ndarray, width: int) -> np.ndarray:
    """Pack nonnegative uint64 codes (< 2**width) into a uint8 bitstream."""
    if width == 0 or len(codes) == 0:
        return np.zeros(0, dtype=np.uint8)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((codes[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits, axis=None)


def _bitunpack(packed: np.ndarray, n: int, width: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, dtype=np.uint64)
    bits = np.unpackbits(packed, count=n * width).reshape(n, width)
    shifts = np.arange(width, dtype=np.uint64)
    return (bits.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)


def _bit_patterns(arr: np.ndarray) -> np.ndarray:
    """The column's raw bit patterns as an unsigned array (exact, total
    order irrelevant — only equality matters for dictionary encoding)."""
    return arr.view(f"u{arr.dtype.itemsize}")


def raw_column(arr: np.ndarray, copy: bool = True) -> EncodedColumn:
    """A verbatim (codec-free) T0 column: at most one copy plus a CRC32.

    This is the pool's fast path — no candidate search — used whenever the
    raw bytes fit the pool's remaining room.  ``copy=False`` adopts the
    caller's array without copying: spill writes hand OWNERSHIP of freshly
    materialized partition arrays to the spill layer (the same contract the
    disk tier has — the caller drops its reference after the write), so the
    pool can keep the buffer itself instead of a memcpy of it.
    """
    arr = np.ascontiguousarray(arr)
    return EncodedColumn("raw", arr.dtype, len(arr), 0, 0,
                         (arr.copy() if copy else arr,), column_crc32(arr))


def encode_column(arr: np.ndarray) -> EncodedColumn:
    """Encode one column for T0; picks the smallest of dict/pack/raw."""
    arr = np.ascontiguousarray(arr)
    crc = column_crc32(arr)
    n = len(arr)
    raw = EncodedColumn("raw", arr.dtype, n, 0, 0, (arr.copy(),), crc)
    if n == 0 or arr.ndim != 1 or arr.dtype.kind not in "iuf":
        return raw
    candidates = [raw]

    u = _bit_patterns(arr)
    # The dict candidate costs an O(n log n) np.unique — real CPU on the
    # spill path.  A strided cardinality probe skips it for columns that
    # are obviously high-cardinality (e.g. float measures), where dict
    # payload (uniques + codes) can never beat raw anyway.
    try_dict = True
    if n > 4096:
        sample = u[:: max(1, n // 1024)]
        try_dict = len(np.unique(sample)) <= len(sample) // 2
    if try_dict:
        uniq, codes = np.unique(u, return_inverse=True)
        width = max(0, int(len(uniq) - 1).bit_length())
        if width < arr.dtype.itemsize * 8:
            packed = _bitpack(codes.astype(np.uint64), width)
            candidates.append(EncodedColumn(
                "dict", arr.dtype, n, width, 0, (uniq, packed), crc))

    if arr.dtype.kind in "iu":
        lo = int(arr.min())
        span = int(arr.max()) - lo
        pwidth = max(0, span.bit_length())
        if pwidth < arr.dtype.itemsize * 8:
            # wrapping subtraction of bit patterns == true delta whenever the
            # span fits 64 bits, which pwidth < 64 guarantees
            with np.errstate(over="ignore"):
                deltas = (u.astype(np.uint64)
                          - np.uint64(lo & 0xFFFFFFFFFFFFFFFF))
            candidates.append(EncodedColumn(
                "pack", arr.dtype, n, pwidth, lo,
                (_bitpack(deltas, pwidth),), crc))

    return min(candidates, key=lambda c: c.nbytes)


def decode_column(enc: EncodedColumn) -> np.ndarray:
    """Exact inverse of :func:`encode_column`; CRC-verified."""
    if enc.kind == "raw":
        out = enc.payload[0]
    elif enc.kind == "dict":
        uniq, packed = enc.payload
        codes = _bitunpack(packed, enc.n, enc.width)
        out = uniq[codes].view(enc.dtype)
    elif enc.kind == "pack":
        deltas = _bitunpack(enc.payload[0], enc.n, enc.width)
        with np.errstate(over="ignore"):
            u = deltas + np.uint64(enc.base & 0xFFFFFFFFFFFFFFFF)
        out = u.astype(f"u{np.dtype(enc.dtype).itemsize}").view(enc.dtype)
    else:  # pragma: no cover - constructor controls kinds
        raise ValueError(f"unknown encoding kind {enc.kind!r}")
    got = column_crc32(out)
    if got != enc.crc:
        raise SpillCorruptionError(
            f"compressed-tier column failed CRC32 (expected {enc.crc:#010x}, "
            f"got {got:#010x}) — pool corruption")
    return out


# ---------------------------------------------------------------------------
# Configuration and accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TierConfig:
    """Capacities and the emulated remote tier's service model.

    ``t1_latency_s``/``t1_gbps`` define T1's deterministic transfer time
    (``latency + bytes/bandwidth``, with a seeded ±10% jitter so repeated
    runs replay the same schedule).  ``t0_byte_s``/``t1_byte_s``/
    ``t2_byte_s`` are the MODELED per-byte service times the pricing stack
    folds into quotes and fragment estimates; ``None`` for T2 means "use
    the cost model's calibrated ``io_byte_cost``".
    """

    t0_capacity: int = 32 * MB
    t1_capacity: Optional[int] = 256 * MB
    t1_latency_s: float = 2e-4
    t1_gbps: float = 1.0
    seed: int = 0
    prefetch: bool = True
    t0_byte_s: float = 1.5e-9
    t2_byte_s: Optional[float] = None

    def t1_byte_s(self, chunk_bytes: int = 256 * 1024) -> float:
        """Modeled seconds per byte through T1 (latency amortized over a
        typical partition-sized transfer)."""
        return 1.0 / (self.t1_gbps * 1e9) + self.t1_latency_s / chunk_bytes

    def byte_costs(self) -> Tuple[float, float, Optional[float]]:
        """(t0, t1, t2) per-byte service times for the pricing stack."""
        return (self.t0_byte_s, self.t1_byte_s(), self.t2_byte_s)


@dataclasses.dataclass
class TierStats:
    """Exact byte books for one tier.  The balance invariant the fig16
    gate asserts: ``bytes_freed == bytes_written`` and ``live_bytes == 0``
    once every partition/run has been consumed — no unaccounted spill."""

    bytes_written: int = 0   # authoritative spill placements (logical bytes)
    bytes_read: int = 0      # demand reads served from this tier
    bytes_freed: int = 0     # returned by delete()
    bytes_promoted: int = 0  # prefetcher promotions INTO this tier (T0 only)
    writes: int = 0
    reads: int = 0
    read_faults: int = 0     # injected/transient read errors survived
    corruptions: int = 0     # CRC failures that triggered failover

    @property
    def live_bytes(self) -> int:
        return max(0, self.bytes_written - self.bytes_freed)

    def as_dict(self) -> Dict[str, int]:
        d = dataclasses.asdict(self)
        d["live_bytes"] = self.live_bytes
        return d

    def merge(self, other: "TierStats") -> None:
        self.bytes_written += other.bytes_written
        self.bytes_read += other.bytes_read
        self.bytes_freed += other.bytes_freed
        self.bytes_promoted += other.bytes_promoted
        self.writes += other.writes
        self.reads += other.reads
        self.read_faults += other.read_faults
        self.corruptions += other.corruptions


class TierLedger:
    """Session-lifetime aggregation of per-query :class:`TierManager` books
    (managers are per-query; the serving report needs totals)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tiers = {t: TierStats() for t in TIER_NAMES}
        self.pool_leaked_bytes = 0   # T0 pool bytes still resident at cleanup
        self.prefetches = 0          # promotions completed
        self.managers = 0

    def absorb(self, stats: Mapping[str, TierStats], pool_leftover: int,
               prefetches: int) -> None:
        with self._lock:
            for name, s in stats.items():
                self._tiers[name].merge(s)
            self.pool_leaked_bytes += int(pool_leftover)
            self.prefetches += int(prefetches)
            self.managers += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                t: self._tiers[t].as_dict() for t in TIER_NAMES}
            out["pool_leaked_bytes"] = self.pool_leaked_bytes
            out["prefetches"] = self.prefetches
            out["managers"] = self.managers
            return out

    def verify_balanced(self) -> None:
        """Raise AssertionError unless every tier's books balance exactly."""
        snap = self.snapshot()
        for t in TIER_NAMES:
            s = snap[t]
            if s["bytes_freed"] != s["bytes_written"] or s["live_bytes"] != 0:
                raise AssertionError(
                    f"tier {t} books do not balance: written="
                    f"{s['bytes_written']} freed={s['bytes_freed']} "
                    f"live={s['live_bytes']}")
        if snap["pool_leaked_bytes"] != 0:
            raise AssertionError(
                f"{snap['pool_leaked_bytes']} T0 pool bytes leaked at quiesce")


# ---------------------------------------------------------------------------
# In-memory run reader (T0/T1 residents)
# ---------------------------------------------------------------------------

class _MemoryRunReader:
    """RunReader-compatible chunked reader over an in-memory relation."""

    def __init__(self, rel: Relation, account: SpillAccount):
        if not rel.columns:
            raise ValueError(
                "spill run contains no column files; cannot determine row "
                "count")
        self.account = account
        self.cols = rel.columns
        self.n = len(next(iter(rel.columns.values())))
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.n

    def read_rows(self, nrows: int) -> Relation:
        end = min(self.n, self.pos + nrows)
        out = {}
        for name, col in self.cols.items():
            chunk = np.asarray(col[self.pos:end])
            out[name] = chunk
            self.account.read(chunk.nbytes)
        self.pos = end
        return Relation(out)


# ---------------------------------------------------------------------------
# TierManager
# ---------------------------------------------------------------------------

class TierManager:
    """Ordered spill-tier hierarchy behind the SpillManager interface.

    Placement: a write lands in the highest tier whose remaining capacity
    (tier capacity ∩ the current operator's grant quota) holds it —
    T0 compressed RAM, then T1 emulated remote, then T2 disk.  Reads prefer
    the highest resident copy and fail over DOWN the hierarchy: a CRC
    failure drops that tier's copy and moves on immediately; a transient
    I/O fault retries per ``retry`` before moving on.  ``prefetch()``
    promotes T1/T2 residents into spare T0 capacity in the background
    (copies, not moves — the authoritative copy stays put, which is what
    makes failover possible).
    """

    def __init__(self, root: Optional[str] = None,
                 config: Optional[TierConfig] = None,
                 faults: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 ledger: Optional[TierLedger] = None):
        self.config = config or TierConfig()
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self.ledger = ledger
        self.disk = SpillManager(root, faults=faults)
        self.dir = self.disk.dir
        self._lock = threading.RLock()
        self._rng = random.Random((self.config.seed, "tier").__hash__()
                                  & 0x7FFFFFFF)
        # base -> {col: EncodedColumn} (T0) / {col: (ndarray, crc)} (T1)
        self._t0: Dict[str, Dict[str, EncodedColumn]] = {}
        self._t1: Dict[str, Dict[str, Tuple[np.ndarray, int]]] = {}
        self._t0_bytes = 0          # encoded pool occupancy
        self._t1_bytes = 0          # logical occupancy
        self._sizes: Dict[str, int] = {}   # logical bytes per live base
        self._home: Dict[str, str] = {}    # authoritative tier per base
        self._stats = {t: TierStats() for t in TIER_NAMES}
        self._quota: Dict[str, Optional[int]] = {"t0": None, "t1": None}
        self._prefetches = 0
        self._closed = False
        # lazy single background promoter; _inflight counts queued+running
        self._pq: "queue.Queue[Optional[str]]" = queue.Queue()
        self._pf_thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._idle = threading.Condition(self._lock)

    # -- lifecycle -----------------------------------------------------------
    def cleanup(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._pf_thread is not None:
            self._pq.put(None)
            self._pf_thread.join(timeout=5.0)
        with self._lock:
            leftover = self._t0_bytes + self._t1_bytes
            if self.ledger is not None:
                self.ledger.absorb(self._stats, leftover, self._prefetches)
            self._t0.clear()
            self._t1.clear()
            self._t0_bytes = 0
            self._t1_bytes = 0
        self.disk.cleanup()

    def __enter__(self) -> "TierManager":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    # -- quota ----------------------------------------------------------------
    def set_op_quota(self, quotas: Optional[Mapping[str, Optional[int]]]) -> None:
        """Apply a :class:`TieredGrant`'s per-tier spill quotas for the
        operator about to run (None → tier capacity alone caps it)."""
        with self._lock:
            if quotas is None:
                self._quota = {"t0": None, "t1": None}
            else:
                self._quota = {"t0": quotas.get("t0"), "t1": quotas.get("t1")}

    def _cap(self, tier: str) -> Optional[int]:
        cap = (self.config.t0_capacity if tier == "t0"
               else self.config.t1_capacity)
        q = self._quota.get(tier)
        if cap is None:
            return q
        return cap if q is None else min(cap, q)

    # -- T1 service model -----------------------------------------------------
    def _t1_transfer(self, nbytes: int) -> None:
        cfg = self.config
        base = cfg.t1_latency_s + nbytes / (cfg.t1_gbps * 1e9)
        with self._lock:
            jitter = 0.9 + 0.2 * self._rng.random()  # seeded, replayable
        if self.faults is not None:
            self.faults.on_remote_read(nbytes)
        time.sleep(base * jitter)

    # -- writes ---------------------------------------------------------------
    # best plausible codec ratio; below 1/this of a write left in the pool,
    # paying the encode just to discover it cannot fit is wasted CPU
    _MAX_RATIO = 16

    def write_relation(self, rel: Relation, tag: str,
                       account: SpillAccount) -> str:
        logical = sum(int(c.nbytes) for c in rel.columns.values())

        # T0: admission is on ENCODED bytes, the pool's real footprint.
        # The codec is real CPU, so it is paid only when it BUYS something:
        # a pool with room for the verbatim bytes takes a raw (memcpy-speed)
        # store — that is what makes T0 faster than page-cached disk — and
        # the dict/pack codec runs only when the raw bytes would not fit
        # but a compressed write still might (it buys admission, the
        # staircase's capacity step, not speed).
        with self._lock:
            cap0 = self._cap("t0")
            room = -1 if cap0 is None else cap0 - self._t0_bytes
        enc: Dict[str, EncodedColumn] = {}
        enc_bytes = logical + 1
        if room < 0 or logical <= room:
            enc = {name: raw_column(col, copy=False)
                   for name, col in rel.columns.items()}
            enc_bytes = sum(e.nbytes for e in enc.values())
        elif logical // self._MAX_RATIO <= room:
            enc = {name: encode_column(col)
                   for name, col in rel.columns.items()}
            enc_bytes = sum(e.nbytes for e in enc.values())
        with self._lock:
            cap0 = self._cap("t0")
            if enc and (cap0 is None
                        or self._t0_bytes + enc_bytes <= cap0):
                base = self.disk._next_path(tag)
                self._t0[base] = enc
                self._t0_bytes += enc_bytes
                self._register(base, "t0", logical, len(rel.columns), account)
                return base
            cap1 = self._cap("t1")
            t1_ok = cap1 is None or self._t1_bytes + logical <= cap1
        if t1_ok and self.config.t1_capacity != 0:
            staged: Dict[str, Tuple[np.ndarray, int]] = {}
            for name, col in rel.columns.items():
                if self.faults is not None:
                    # T1 is an I/O tier: the write-fault site applies
                    self.faults.on_spill_column(f"t1:{tag}/{name}")
                col = np.ascontiguousarray(col)
                staged[name] = (col.copy(), column_crc32(col))
            self._t1_transfer(logical)
            with self._lock:
                base = self.disk._next_path(tag)
                self._t1[base] = staged   # publish complete or not at all
                self._t1_bytes += logical
                self._register(base, "t1", logical, len(rel.columns), account)
            return base

        base = self.disk.write_relation(rel, tag, account)  # accounts itself
        with self._lock:
            self._sizes[base] = logical
            self._home[base] = "t2"
            s = self._stats["t2"]
            s.bytes_written += logical
            s.writes += 1
        return base

    def _register(self, base: str, tier: str, logical: int, ncols: int,
                  account: SpillAccount) -> None:
        """Book a completed T0/T1 placement (lock held)."""
        self._sizes[base] = logical
        self._home[base] = tier
        s = self._stats[tier]
        s.bytes_written += logical
        s.writes += 1
        account.write(logical)
        account.files_created += ncols

    # -- reads ----------------------------------------------------------------
    def _resident_tiers(self, base: str) -> List[str]:
        out = []
        if base in self._t0:
            out.append("t0")
        home = self._home.get(base)
        if home in ("t1", "t2"):
            out.append(home)
        return out

    def _read_tier(self, tier: str, base: str) -> Relation:
        """One read attempt from one tier; raises on fault/corruption."""
        if tier == "t0":
            with self._lock:
                enc = dict(self._t0[base])
            return Relation({name: decode_column(e)
                             for name, e in enc.items()})
        if tier == "t1":
            with self._lock:
                staged = dict(self._t1[base])
                logical = self._sizes.get(base, 0)
            if self.faults is not None:
                self.faults.on_spill_read(f"t1:{base}")
            self._t1_transfer(logical)
            cols = {}
            for name, (col, crc) in staged.items():
                if column_crc32(col) != crc:
                    raise SpillCorruptionError(
                        f"remote-tier column {name!r} at {base!r} failed "
                        f"CRC32 — torn or bit-flipped transfer")
                cols[name] = col
            return Relation(cols)
        # t2: the disk manager injects read faults and verifies CRCs itself
        return self.disk.read_relation(base, SpillAccount())

    def _drop_copy(self, tier: str, base: str,
                   logical: Optional[int] = None) -> None:
        with self._lock:
            if tier == "t0":
                enc = self._t0.pop(base, None)
                if enc is not None:
                    self._t0_bytes -= sum(e.nbytes for e in enc.values())
            elif tier == "t1":
                staged = self._t1.pop(base, None)
                if staged is not None:
                    if logical is None:
                        logical = self._sizes.get(base, 0)
                    self._t1_bytes -= logical

    def _read_with_failover(self, base: str) -> Tuple[Relation, str]:
        """Read ``base`` from the highest resident tier, retrying transient
        faults per policy and failing over down the hierarchy on exhausted
        retries or corruption."""
        with self._lock:
            tiers = self._resident_tiers(base)
        if not tiers:
            raise KeyError(f"no resident spill copy for {base!r}")
        last: Optional[BaseException] = None
        for idx, tier in enumerate(tiers):
            is_last_tier = idx == len(tiers) - 1
            for attempt in range(1, self.retry.max_attempts + 1):
                try:
                    return self._read_tier(tier, base), tier
                except SimulatedCrash:
                    raise
                except SpillCorruptionError as e:
                    # this copy is damaged: retrying the same bytes cannot
                    # help — drop it and fail over immediately
                    last = e
                    with self._lock:
                        self._stats[tier].corruptions += 1
                    if not (is_last_tier and tier == self._home.get(base)):
                        self._drop_copy(tier, base)
                    break
                except TransientError as e:
                    last = e
                    with self._lock:
                        self._stats[tier].read_faults += 1
                    if attempt < self.retry.max_attempts:
                        time.sleep(self.retry.backoff(attempt))
        assert last is not None
        raise last

    def read_relation(self, base: str, account: SpillAccount) -> Relation:
        rel, tier = self._read_with_failover(base)
        logical = sum(int(c.nbytes) for c in rel.columns.values())
        account.read(logical)
        with self._lock:
            s = self._stats[tier]
            s.bytes_read += logical
            s.reads += 1
        return rel

    def open_run_reader(self, base: str, account: SpillAccount):
        with self._lock:
            tiers = self._resident_tiers(base)
        if tiers == ["t2"]:
            return self.disk.open_run_reader(base, account)
        rel, tier = self._read_with_failover(base)
        with self._lock:
            s = self._stats[tier]
            s.bytes_read += sum(int(c.nbytes) for c in rel.columns.values())
            s.reads += 1
        # account counts incrementally as read_rows() consumes, matching
        # the disk RunReader's accounting contract
        return _MemoryRunReader(rel, account)

    # -- deletes --------------------------------------------------------------
    def delete(self, base: str, account: Optional[SpillAccount] = None) -> None:
        with self._lock:
            # unregister FIRST: an in-flight promotion re-checks _sizes
            # before publishing into the pool, so popping here closes the
            # promote-after-delete leak window
            logical = self._sizes.pop(base, None)
            home = self._home.pop(base, None)
            if logical is not None:
                self._drop_copy("t0", base)
                self._drop_copy("t1", base, logical)
                if home in self._stats:
                    self._stats[home].bytes_freed += logical
        if logical is None:
            self.disk.delete(base, account)
            return
        if home == "t2":
            self.disk.delete(base, account)
        elif account is not None:
            account.free(logical)

    # -- prefetch -------------------------------------------------------------
    def prefetch(self, bases: Sequence[str]) -> None:
        """Queue T1/T2 residents for background promotion into spare T0
        capacity (best-effort, ordered; no-op on T0 residents)."""
        if not self.config.prefetch or not bases:
            return
        with self._lock:
            if self._closed:
                return
            if self._pf_thread is None:
                self._pf_thread = threading.Thread(
                    target=self._pf_loop, name="tier-prefetch", daemon=True)
                self._pf_thread.start()
            for b in bases:
                self._inflight += 1
                self._pq.put(b)

    def drain_prefetch(self, timeout_s: float = 10.0) -> None:
        """Block until every queued promotion has been attempted (tests and
        quiesce barriers)."""
        deadline = time.monotonic() + timeout_s
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._idle.wait(remaining)

    def _pf_loop(self) -> None:
        while True:
            base = self._pq.get()
            if base is None:
                return
            try:
                self._promote(base)
            except BaseException:
                pass  # best-effort: the authoritative copy is untouched
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()

    def _promote(self, base: str) -> None:
        with self._lock:
            if (self._closed or base in self._t0
                    or self._home.get(base) not in ("t1", "t2")):
                return
        # read outside the lock: promotion I/O must overlap foreground work
        rel, _tier = self._read_with_failover(base)
        enc = {name: encode_column(col) for name, col in rel.columns.items()}
        enc_bytes = sum(e.nbytes for e in enc.values())
        with self._lock:
            # re-check: the partition may have been consumed+deleted while
            # we were reading, and the pool may have filled
            cap0 = self._cap("t0")
            if (self._closed or base not in self._sizes or base in self._t0
                    or cap0 is None or self._t0_bytes + enc_bytes > cap0):
                return
            self._t0[base] = enc
            self._t0_bytes += enc_bytes
            self._stats["t0"].bytes_promoted += self._sizes[base]
            self._prefetches += 1

    # -- observability --------------------------------------------------------
    def tier_stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {t: self._stats[t].as_dict() for t in TIER_NAMES}

    @property
    def pool_bytes(self) -> int:
        with self._lock:
            return self._t0_bytes

    @property
    def prefetches(self) -> int:
        with self._lock:
            return self._prefetches
