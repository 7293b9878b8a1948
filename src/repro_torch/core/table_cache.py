"""Device-resident base-table cache + key-cardinality sketches (serving path).

Repeated queries over the same base tables are the serving-path common case:
a per-query host→device upload (and pow2 re-padding) of columns that have not
changed since the last query is pure amortizable overhead, exactly like the
per-query planning `np.unique` sample the selector used to pay.  This module
makes both **resident across queries**:

  * :func:`get_device_columns` — bucket-padded (or exact-shape) device uploads
    of a relation's columns, cached *on the relation instance* and keyed by a
    sampled content token (:func:`repro_torch.core.relation.column_token`).  A warm
    query transfers **zero** H2D bytes.  Rebinding/resizing/re-dtyping a
    column always changes the token; in-place element writes are caught with
    sampled confidence only — mutating callers must use
    :meth:`Relation.invalidate_device_cache` for a guaranteed refresh
    (Relations are immutable by convention).
  * :func:`key_stats` — a cached key-cardinality sketch (sample cardinality,
    duplication factor, min/max) shared by `PathSelector.choose_join` and the
    fused pipeline's host planner, so neither pays a 64k-row `np.unique` per
    query.

Storing the cache on the `Relation` instance ties entry lifetime to the table
itself (dropped with the relation, no global growth) and sidesteps `id()`
reuse.  Sub-relations made with :meth:`Relation.select` share the parent's
cache dicts *by reference*: the planner's projection-pruned scans (fresh
instances every query) re-use — and warm — the base table's uploads and
sketches, entries stay token-checked per column, and
:meth:`Relation.invalidate_device_cache` on the parent reaches every
selection.  `REPRO_TABLE_CACHE=0` disables caching (every query re-uploads
and re-samples); global hit/miss/H2D counters are exposed via
:func:`table_cache_info` for tests and benchmarks.

Cache/sketch bookkeeping is serialized by one module lock (the transfers
and scans themselves run outside it), so concurrent serving sessions can
share base tables without a cold upload stalling warm lookups.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import upload
from .codec_device import (DeviceCodes, DeviceColumnLayout, choose_layout,
                           compress_enabled, dict_bucket, encode_host,
                           pad_dictionary)
from .relation import Relation, column_token

__all__ = [
    "KeyStats",
    "cache_enabled",
    "column_layout",
    "device_cache_resident_bytes",
    "get_device_columns",
    "get_device_layouts",
    "pending_upload_bytes",
    "key_stats",
    "table_cache_info",
    "table_cache_clear",
]

_CACHE_ATTR = "_device_cache"
_STATS_ATTR = "_key_stats"
_LAYOUT_ATTR = "_layout_cache"
SAMPLE_ROWS = 65536  # key-cardinality sample size (matches the seed selector)


@dataclasses.dataclass
class _Counters:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    h2d_bytes: int = 0
    h2d_bytes_logical: int = 0
    sketch_hits: int = 0
    sketch_misses: int = 0
    layout_hits: int = 0
    layout_misses: int = 0


_COUNTERS = _Counters()

# One lock for every per-relation cache dict and the global counters:
# concurrent serving sessions share base tables, and cache bookkeeping must
# not mutate a dict mid-probe.  The lock guards the DICTS, not the compute:
# uploads and sketch scans run outside it (double-checked insert), so a
# cold multi-MB transfer never parks other sessions' warm lookups.  A rare
# racing pair both upload the same column — real transferred bytes, still
# reported — and every later query is warm.
_LOCK = threading.RLock()


def cache_enabled() -> bool:
    """Base-table cache toggle: ``REPRO_TABLE_CACHE=0`` disables residency."""
    return os.environ.get("REPRO_TABLE_CACHE", "1") != "0"


def table_cache_info() -> Dict[str, int]:
    with _LOCK:
        return dataclasses.asdict(_COUNTERS)


def table_cache_clear() -> None:
    """Reset the global counters.  Per-relation storage lives on the Relation
    instances themselves — drop it with ``rel.invalidate_device_cache()``."""
    global _COUNTERS
    with _LOCK:
        _COUNTERS = _Counters()


def _upload(col: np.ndarray, bucket: Optional[int], device: torch.device):
    """Host→device transfer of one column, optionally zero-padded to a
    power-of-two bucket (original dtype preserved)."""
    if bucket is not None:
        pad = bucket - len(col)
        if pad:
            col = np.concatenate([col, np.zeros(pad, col.dtype)])
    return upload(col, device)


def _padded_nbytes(col: np.ndarray, bucket: Optional[int]) -> int:
    n = len(col) if bucket is None else bucket
    return int(n * col.dtype.itemsize)


def _dev_key(device) -> str:
    return str(torch.device(device))


def get_device_columns(rel: Relation, bucket: Optional[int] = None,
                       device="cuda") -> Tuple[Dict[str, object], int]:
    """Device arrays for all columns of ``rel`` plus the H2D bytes this call
    actually transferred (0 on a fully warm cache).

    ``bucket`` pads every column to that power-of-two length (the fused
    pipeline's shape-bucketed contract); ``None`` keeps exact shapes (the
    per-operator device path).  Entries are keyed ``(name, bucket,
    device)`` and hold the column's content token, so the two shapes (and
    devices) coexist and a stale token is replaced in place.
    """
    device = torch.device(device)
    dkey = _dev_key(device)
    uploaded = 0
    out: Dict[str, object] = {}
    if not cache_enabled():
        for name, col in rel.columns.items():
            out[name] = _upload(col, bucket, device)
            uploaded += _padded_nbytes(col, bucket)
        with _LOCK:
            _COUNTERS.misses += len(rel.columns)
            _COUNTERS.h2d_bytes += uploaded
        return out, uploaded
    tokens = {name: column_token(col) for name, col in rel.columns.items()}
    missing = []
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        for name in rel.columns:
            entry = cache.get((name, bucket, dkey))
            if entry is not None and entry[0] == tokens[name]:
                _COUNTERS.hits += 1
                out[name] = entry[1]
                continue
            if entry is not None:
                _COUNTERS.invalidations += 1  # mutated column → fresh transfer
            _COUNTERS.misses += 1
            missing.append(name)
    # transfers run OUTSIDE the lock (cf. key_stats): a cold multi-MB
    # upload must not park every other session's warm dict probes behind
    # it.  Two queries racing on the same cold column both transfer (the
    # bytes they report were really moved); the last insert wins and all
    # later queries are warm.
    for name in missing:
        col = rel.columns[name]
        out[name] = _upload(col, bucket, device)
        uploaded += _padded_nbytes(col, bucket)
    if missing:
        with _LOCK:
            for name in missing:
                cache[(name, bucket, dkey)] = (tokens[name], out[name])
            _COUNTERS.h2d_bytes += uploaded
    return out, uploaded


def column_layout(rel: Relation, name: str
                  ) -> Tuple[DeviceColumnLayout, Optional[np.ndarray]]:
    """Packed-layout descriptor for one column, cached per (relation,
    column, content token) next to the key sketch.

    The descriptor (and, for dictionary layouts, the sorted host-side
    dictionary) is the fingerprint-keyed analysis the upload and costing
    paths share — neither re-scans the column once a fresh entry exists.
    With ``REPRO_DEVICE_COMPRESS=0`` the cache is bypassed entirely and
    every column reports a ``raw`` layout.
    """
    col = rel.columns[name]
    if not compress_enabled():
        return choose_layout(col)  # degrades to raw, nothing worth caching
    token = column_token(col)
    with _LOCK:
        cache = (rel.__dict__.setdefault(_LAYOUT_ATTR, {})
                 if cache_enabled() else None)
        if cache is not None:
            entry = cache.get(name)
            if entry is not None and entry[0] == token:
                _COUNTERS.layout_hits += 1
                return entry[1], entry[2]
        _COUNTERS.layout_misses += 1
    # the O(N) min/max/unique scans run OUTSIDE the lock (cf. key_stats)
    layout, aux = choose_layout(col)
    if cache is not None:
        with _LOCK:
            cache[name] = (token, layout, aux)
    return layout, aux


def get_device_layouts(rel: Relation, bucket: Optional[int] = None,
                       device="cuda"
                       ) -> Tuple[Dict[str, DeviceCodes], int, int]:
    """Packed device columns for ``rel``: ``(cols, physical, logical)``.

    ``cols`` maps column name → :class:`DeviceCodes` (device codes +
    layout + device dictionary); ``physical`` is the H2D bytes this call
    actually moved (packed codes + dictionaries), ``logical`` the bytes
    the same call would have moved at logical width — the pair the
    executor reports as ``h2d_bytes`` vs ``h2d_bytes_logical``.

    Storage discipline: ``raw``-layout columns share the plain
    ``get_device_columns`` entries (key ``(name, bucket, device)``); packed
    columns live under ``(name, bucket, device, "c")`` in the *same* per-relation
    cache dict, so :meth:`Relation.invalidate_device_cache` drops codes,
    dictionaries and raw uploads together.  A column whose logical-width
    copy is already resident is served from it rather than re-uploaded
    packed — zero transfer always beats a smaller transfer.
    """
    device = torch.device(device)
    dkey = _dev_key(device)
    layouts = {name: column_layout(rel, name) for name in rel.columns}
    packed = [n for n, (lay, _) in layouts.items() if lay.encoding != "raw"]
    raw = [n for n in rel.columns if n not in packed]
    out: Dict[str, DeviceCodes] = {}
    up_phys = up_log = 0
    if raw:
        dev_raw, up_raw = get_device_columns(rel.select(raw), bucket, device)
        for name in raw:
            out[name] = DeviceCodes(dev_raw[name], layouts[name][0])
        up_phys += up_raw
        up_log += up_raw
    if not packed:
        return out, up_phys, up_log
    tokens = {name: column_token(rel.columns[name]) for name in packed}
    if not cache_enabled():
        for name in packed:
            dc, phys = _upload_packed(rel.columns[name], *layouts[name],
                                      bucket, device)
            out[name] = dc
            up_phys += phys
            up_log += _padded_nbytes(rel.columns[name], bucket)
        with _LOCK:
            _COUNTERS.misses += len(packed)
            _COUNTERS.h2d_bytes += up_phys
            _COUNTERS.h2d_bytes_logical += up_log
        return out, up_phys, up_log
    missing = []
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        for name in packed:
            entry = cache.get((name, bucket, dkey, "c"))
            if entry is not None and entry[0] == tokens[name]:
                _COUNTERS.hits += 1
                out[name] = entry[1]
                continue
            raw_entry = cache.get((name, bucket, dkey))
            if raw_entry is not None and raw_entry[0] == tokens[name]:
                # logical-width copy already resident: reuse it — zero
                # transfer beats uploading packed codes next to it
                _COUNTERS.hits += 1
                col = rel.columns[name]
                out[name] = DeviceCodes(
                    raw_entry[1],
                    DeviceColumnLayout("raw", col.dtype.name, col.dtype.name,
                                       len(col)))
                continue
            if entry is not None:
                _COUNTERS.invalidations += 1  # mutated column → re-encode
            _COUNTERS.misses += 1
            missing.append(name)
    # encodes + transfers outside the lock (same double-checked-insert
    # discipline as get_device_columns)
    fresh_phys = fresh_log = 0
    for name in missing:
        dc, phys = _upload_packed(rel.columns[name], *layouts[name], bucket,
                                  device)
        out[name] = dc
        fresh_phys += phys
        fresh_log += _padded_nbytes(rel.columns[name], bucket)
    if missing:
        with _LOCK:
            for name in missing:
                cache[(name, bucket, dkey, "c")] = (tokens[name], out[name])
            _COUNTERS.h2d_bytes += fresh_phys
            _COUNTERS.h2d_bytes_logical += fresh_log
    return out, up_phys + fresh_phys, up_log + fresh_log


def _upload_packed(col: np.ndarray, layout: DeviceColumnLayout,
                   dictionary: Optional[np.ndarray],
                   bucket: Optional[int],
                   device: torch.device) -> Tuple[DeviceCodes, int]:
    """Encode + transfer one packed column; returns the DeviceCodes and
    the physical bytes moved (codes + padded dictionary)."""
    codes = encode_host(col, layout, dictionary)
    dev_codes = _upload(codes, bucket, device)
    phys = _padded_nbytes(codes, bucket)
    dict_dev = None
    if layout.encoding == "dict":
        padded = pad_dictionary(dictionary, dict_bucket(layout.card))
        dict_dev = upload(padded, device)
        phys += int(padded.nbytes)
    return DeviceCodes(dev_codes, layout, dict_dev), phys


def pending_upload_bytes(rel, bucket: Optional[int] = None,
                         device="cuda") -> int:
    """H2D bytes a query over ``rel`` would pay *right now* — the explicit
    transfer term the plan-level cost model charges the tensor path.  Zero
    when every column is already device-resident at this bucket.

    With compression on this prices what :func:`get_device_layouts` would
    actually move — *packed* bytes (plus dictionaries) — and a column
    resident in either physical form (packed codes or a logical-width
    upload) is free, matching the reuse rule above."""
    if not isinstance(rel, Relation):
        return 0  # already device-resident
    comp = compress_enabled()
    # token hashing and layout analysis outside the lock (the discipline
    # everywhere in this module): this probe runs on every fragment
    # decision of every session — layouts are fingerprint-cached
    dkey = _dev_key(device)
    tokens = {name: column_token(col) for name, col in rel.columns.items()}
    layouts = ({name: column_layout(rel, name)[0] for name in rel.columns}
               if comp else None)
    total = 0
    with _LOCK:
        cache = rel.__dict__.get(_CACHE_ATTR) if cache_enabled() else None
        for name, col in rel.columns.items():
            if cache is not None:
                entry = cache.get((name, bucket, dkey))
                if entry is not None and entry[0] == tokens[name]:
                    continue
                if comp:
                    entry = cache.get((name, bucket, dkey, "c"))
                    if entry is not None and entry[0] == tokens[name]:
                        continue
            if comp:
                rows = len(col) if bucket is None else bucket
                total += layouts[name].upload_bytes(rows)
            else:
                total += _padded_nbytes(col, bucket)
    return total


def device_cache_resident_bytes(rel) -> int:
    """Device bytes currently held by this relation's cached device state —
    raw uploads, packed codes and dictionaries (on every device)."""
    if not isinstance(rel, Relation):
        return 0
    total = 0
    with _LOCK:
        for entry in (rel.__dict__.get(_CACHE_ATTR) or {}).values():
            obj = entry[1]
            if isinstance(obj, DeviceCodes):
                total += int(obj.codes.nbytes)
                if obj.dict_values is not None:
                    total += int(obj.dict_values.nbytes)
            else:
                total += int(obj.nbytes)
    return total


@dataclasses.dataclass(frozen=True)
class KeyStats:
    """Cached execution-time observables of one key column (§III.C)."""

    n: int            # column length
    sample_n: int     # rows sampled for cardinality
    card: int         # distinct keys in the sample
    dup: float        # average duplication factor (sample)
    kmin: object      # column minimum (exact Python scalar)
    kmax: object      # column maximum


def key_stats(rel: Relation, key: str) -> KeyStats:
    """Key-cardinality sketch, cached per (relation, key, content token).

    The seed selector re-ran ``np.unique`` over a 65536-row sample on every
    ``choose_join`` call — per-query planning overhead this cache amortizes
    away for repeated queries over the same base tables.
    """
    col = np.asarray(rel[key])
    token = column_token(col)
    with _LOCK:
        cache = (rel.__dict__.setdefault(_STATS_ATTR, {})
                 if cache_enabled() else None)
        if cache is not None:
            entry = cache.get(key)
            if entry is not None and entry[0] == token:
                _COUNTERS.sketch_hits += 1
                return entry[1]
        _COUNTERS.sketch_misses += 1
    # the O(N) scans run OUTSIDE the lock (cf. planner._packed_column):
    # holding it would park every session's warm lookups — on unrelated
    # tables — behind one cold sketch; a rare racing double-sketch of the
    # same column computes identical stats and is cheaper
    n = len(col)
    if n == 0:
        stats = KeyStats(0, 0, 0, 1.0, 0, 0)
    else:
        sample = col[: min(n, SAMPLE_ROWS)]
        card = max(1, len(np.unique(sample)))
        dup = max(1.0, len(sample) / card)
        # min/max over the full column: one O(N) scan each, amortized by
        # the cache (the fused planner needs the exact key range, not a
        # sample's)
        stats = KeyStats(n, len(sample), card, dup,
                         col.min().item(), col.max().item())
    if cache is not None:
        with _LOCK:
            cache[key] = (token, stats)
    return stats
