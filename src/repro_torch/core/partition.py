"""Radix partitioning for sharded fused fragments (host-side, cached).

The sharded tensor path splits a fused Join→[Filter]→[Agg] fragment into
``num_parts`` co-partitions by a multiplicative hash of the join key and
runs every partition at once on one device, one logical lane each
(:mod:`repro_torch.distributed.sharding`): each partitioned column is one
``(num_parts, bucket)`` tensor whose row ``p`` holds partition ``p``.  This
module owns the host side of that contract:

  * **Partitioning contract** — row ``i`` lands in partition
    ``hash64(key[i]) >> (64 - log2 P)`` (Fibonacci multiplicative hash,
    robust to skewed/clustered key domains).  Both join sides use the same
    function, so matching keys always meet in the same partition and a
    per-partition join is exact.
  * **Sorted runs** — the *build* side of a partition is stored sorted by
    the join key.  That turns each per-partition join into a searchsorted
    probe over a resident run with **no per-query device sort at all**.
    The one-time partition+sort pass is amortized across queries exactly
    like the device-resident base-table cache
    (:mod:`repro_torch.core.table_cache`), whose caching discipline this
    module mirrors: entries live **on the Relation instance** (dropped with
    the table, shared with ``select()`` sub-relations), are keyed by
    sampled content tokens and the device, and bookkeeping is serialized by
    one module lock while partitioning and transfers run outside it.
  * **Skew-aware sizing** — per-partition buckets are quarter-power-of-two
    (bounded shape count for the program cache, ≤25% padding waste even
    under skew, vs. up-to-2x for plain pow2 when partition counts land
    just past a power of two), and :func:`partition_skew` reports
    ``max/mean`` partition fill so the cost model can price the critical
    partition of a skewed key distribution.

Padding: the key column pads with the int64 sentinel (``_I64_MAX`` — the
documented key-domain exclusion the fused path already relies on), which
also sorts past every real key so sorted runs stay sorted through their
padding; payload columns pad with zeros and are never read (validity is
masked by the per-partition row counts).

Packed payloads: the join KEY column always stays logical int64 — the
sentinel padding and cross-relation co-partitioning contracts live in the
value domain — but payload columns store *packed codes* per their cached
:func:`~repro_torch.core.table_cache.column_layout` (dictionary /
frame-of-reference; :mod:`repro_torch.core.codec_device`), so warm sharded
queries keep packed bytes resident and cold ones upload packed bytes.
Dictionaries ride next to the partitioned columns (one copy serves every
partition) and the sharded program decodes at gather, same as the
single-device fused path.

The host pass is the reference's, step for step, so every partitioned
column equals the reference's element by element.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import upload
from .codec_device import (DeviceColumnLayout, compress_enabled, dict_bucket,
                           encode_host, pad_dictionary)
from .relation import Relation, column_token
from .table_cache import _dev_key

__all__ = [
    "PART_MIN_BUCKET",
    "partition_bucket",
    "partition_of",
    "partition_counts",
    "partition_skew",
    "get_partitioned_columns",
    "pending_partition_bytes",
    "partition_cache_info",
    "partition_cache_clear",
]

_I64_MAX = np.iinfo(np.int64).max
_FIB = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / golden ratio

_CACHE_ATTR = "_partition_cache"
PART_MIN_BUCKET = 4096


class _Counters:
    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.h2d_bytes = 0


_COUNTERS = _Counters()
# Same discipline as table_cache: the lock guards the per-relation cache
# dicts and the counters; partitioning passes and device transfers run
# outside it (double-checked insert — a racing pair both partition, both
# results are identical, every later query is warm).
_LOCK = threading.RLock()


def partition_cache_info() -> Dict[str, int]:
    with _LOCK:
        return {"hits": _COUNTERS.hits, "misses": _COUNTERS.misses,
                "h2d_bytes": _COUNTERS.h2d_bytes}


def partition_cache_clear() -> None:
    with _LOCK:
        _COUNTERS.hits = 0
        _COUNTERS.misses = 0
        _COUNTERS.h2d_bytes = 0


def partition_bucket(n: int) -> int:
    """Quarter-power-of-two shape bucket for per-partition arrays.

    Plain pow2 buckets double a partition's padding the moment skew pushes
    its fill just past a power of two — with P partitions that waste is
    paid P times.  Quarter-pow2 steps (4 buckets per octave) bound padding
    at 25% while keeping the compiled-shape universe small."""
    n = max(PART_MIN_BUCKET, int(n))
    p = 1 << (int(n - 1).bit_length())  # next pow2 >= n
    for num in (5, 6, 7):  # p/2 * 1.25 / 1.5 / 1.75
        q = (p >> 3) * num
        if q >= n:
            return q
    return p


def partition_of(keys: np.ndarray, num_parts: int) -> np.ndarray:
    """Partition id per row: top bits of the Fibonacci hash of the int64
    key, folded to ``num_parts``.  Identical on both join sides."""
    h = keys.astype(np.int64, copy=False).view(np.uint64) * _FIB
    # top 32 hash bits scaled to [0, num_parts): unbiased enough for
    # partitioning and free of the modulo's weakness on even key strides
    return ((h >> np.uint64(32)) * np.uint64(num_parts)
            >> np.uint64(32)).astype(np.int64)


def partition_counts(rel: Relation, key: str, num_parts: int) -> np.ndarray:
    """Exact per-partition row counts for ``rel`` under the partitioning
    contract — one O(n) hash pass, memoized on the relation instance by
    content token (the selector prices skew per decision; warm serving
    queries must not pay a per-query hash pass, the same discipline as
    ``key_stats``)."""
    num_parts = int(num_parts)
    token = column_token(rel[key])
    memo_key = ("counts", key, num_parts)
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        hit = cache.get(memo_key)
        if hit is not None and hit[0] == token:
            _COUNTERS.hits += 1
            return hit[1]
        _COUNTERS.misses += 1
    counts = np.bincount(partition_of(rel[key], num_parts),
                         minlength=num_parts).astype(np.int64)
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        cache[memo_key] = (token, counts)
    return counts


def partition_skew(counts: np.ndarray) -> float:
    """``max/mean`` partition fill — 1.0 is perfectly balanced; the cost
    model charges the sharded path's critical partition with this factor."""
    counts = np.asarray(counts, dtype=np.int64)
    mean = float(counts.mean()) if len(counts) else 0.0
    if mean <= 0:
        return 1.0
    return float(counts.max()) / mean


def _build_partitions(rel: Relation, key: str, num_parts: int,
                      sort_within: bool):
    """One partitioning pass over the host columns.

    Returns ``(host_cols, counts, bucket, layouts, dicts_host)`` where each
    host column is a ``(num_parts, bucket)`` array with partition ``p``'s
    rows in its first ``counts[p]`` slots.  ``sort_within`` additionally
    orders each partition's rows by the join key (the build-side sorted-run
    layout).  Payload columns are stored as packed codes per ``layouts``;
    ``dicts_host`` holds the bucket-padded dictionaries of ``dict``-encoded
    payloads (the key column is always logical int64 — sentinel contract)."""
    from .table_cache import column_layout

    keys = np.asarray(rel[key])
    part = partition_of(keys, num_parts)
    if sort_within:
        order = np.lexsort((keys, part))  # partition-major, key-minor
    else:
        order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=num_parts).astype(np.int64)
    bucket = partition_bucket(int(counts.max()) if len(counts) else 0)
    offsets = np.zeros(num_parts + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    host_cols = {}
    layouts: Dict[str, DeviceColumnLayout] = {}
    dicts_host = {}
    for name in rel.names:
        col = np.asarray(rel[name])[order]
        if name == key and not np.issubdtype(col.dtype, np.integer):
            raise TypeError(f"join key {name!r} must be integer-typed")
        if name == key:
            buf = np.full((num_parts, bucket), _I64_MAX, dtype=np.int64)
            col = col.astype(np.int64, copy=False)
            layouts[name] = DeviceColumnLayout("raw", "int64", "int64",
                                               len(col))
        else:
            lay, aux = column_layout(rel, name)
            layouts[name] = lay
            if lay.encoding != "raw":
                col = encode_host(col, lay, aux)  # zero pad = a dead code,
                # never read (masked by counts)
            if lay.encoding == "dict":
                dicts_host[name] = pad_dictionary(aux, dict_bucket(lay.card))
            buf = np.zeros((num_parts, bucket), dtype=col.dtype)
        for p in range(num_parts):
            buf[p, :counts[p]] = col[offsets[p]:offsets[p + 1]]
        host_cols[name] = buf
    return host_cols, counts, bucket, layouts, dicts_host


def _upload(host_cols, counts, dicts_host, device: torch.device):
    """Host→device placement of a partitioned layout: each ``(P, bucket)``
    column becomes one tensor on ``device`` whose row ``p`` is partition
    ``p``, so the sharded program consumes it with no per-call reshaping.
    Dictionaries are small and serve every partition."""
    cols = {name: upload(buf, device) for name, buf in host_cols.items()}
    counts_dev = upload(counts, device)
    dicts_dev = {name: upload(d, device) for name, d in dicts_host.items()}
    return cols, counts_dev, dicts_dev


def get_partitioned_columns(rel: Relation, key: str, num_parts: int,
                            sort_within: bool, device="cuda"):
    """Partitioned device columns for ``rel``, cached on the instance.

    Returns ``(cols, counts_dev, counts, bucket, uploaded_bytes,
    logical_bytes, layouts, dicts)``: ``cols`` maps column name →
    ``(num_parts, bucket)`` tensor on ``device`` (packed codes for
    compressed payloads), ``counts_dev`` the per-partition row counts as a
    ``(num_parts,)`` tensor on ``device``, ``counts`` the same on host,
    ``uploaded_bytes`` the physical H2D
    traffic this call actually paid (0 on a warm hit — the serving-path
    contract) and ``logical_bytes`` the same transfer priced at logical
    column width.  ``layouts`` maps name → :class:`~repro_torch.core.
    codec_device.DeviceColumnLayout`; ``dicts`` maps ``dict``-encoded
    payload names to their device dictionaries.  Entries are keyed by the
    device too, so a CPU and a CUDA layout of one table coexist."""
    num_parts = int(num_parts)
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    device = torch.device(device)
    tokens = tuple((name, column_token(rel[name])) for name in rel.names)
    cache_key = (key, num_parts, bool(sort_within), _dev_key(device))
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        entry = cache.get(cache_key)
        if entry is not None and entry["tokens"] == tokens:
            _COUNTERS.hits += 1
            return (entry["cols"], entry["counts_dev"], entry["counts"],
                    entry["bucket"], 0, 0, entry["layouts"], entry["dicts"])
        _COUNTERS.misses += 1
    host_cols, counts, bucket, layouts, dicts_host = _build_partitions(
        rel, key, num_parts, sort_within)
    cols, counts_dev, dicts_dev = _upload(host_cols, counts, dicts_host,
                                          device)
    uploaded = sum(int(b.nbytes) for b in host_cols.values()) + counts.nbytes
    uploaded += sum(int(d.nbytes) for d in dicts_host.values())
    logical = int(num_parts * bucket
                  * sum((8 if name == key else rel[name].dtype.itemsize)
                        for name in rel.names)) + int(counts.nbytes)
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        current = cache.get(cache_key)
        if current is not None and current["tokens"] == tokens:
            # racing pair: keep the first insert, both transfers were real
            _COUNTERS.h2d_bytes += uploaded
            return (current["cols"], current["counts_dev"],
                    current["counts"], current["bucket"], uploaded, logical,
                    current["layouts"], current["dicts"])
        cache[cache_key] = {"tokens": tokens, "cols": cols,
                            "counts_dev": counts_dev, "counts": counts,
                            "bucket": bucket, "layouts": layouts,
                            "dicts": dicts_dev}
        _COUNTERS.h2d_bytes += uploaded
    return (cols, counts_dev, counts, bucket, uploaded, logical, layouts,
            dicts_dev)


def pending_partition_bytes(rel: Relation, key: str, num_parts: int,
                            sort_within: bool, device="cuda") -> int:
    """H2D bytes :func:`get_partitioned_columns` would transfer right now —
    0 when the partitioned layout is already resident on ``device`` (the
    selector's cache-aware cost term, mirroring ``pending_upload_bytes``).
    With compression on this prices the PACKED layout (narrow payload
    codes + dictionaries), so the selector sees the sharded candidate's
    true, cheaper transfer."""
    num_parts = int(num_parts)
    tokens = tuple((name, column_token(rel[name])) for name in rel.names)
    with _LOCK:
        cache = rel.__dict__.get(_CACHE_ATTR)
        if cache is not None:
            entry = cache.get((key, num_parts, bool(sort_within),
                               _dev_key(device)))
            if entry is not None and entry["tokens"] == tokens:
                return 0
    counts = partition_counts(rel, key, num_parts)
    bucket = partition_bucket(int(counts.max()) if len(counts) else 0)
    per_row = 0
    dict_bytes = 0
    if compress_enabled():
        from .table_cache import column_layout

        for name in rel.names:
            if name == key:
                per_row += 8
                continue
            lay = column_layout(rel, name)[0]
            per_row += lay.code_itemsize
            if lay.encoding == "dict":
                dict_bytes += dict_bucket(lay.card) * lay.logical_itemsize
    else:
        per_row = sum((8 if name == key else rel[name].dtype.itemsize)
                      for name in rel.names)
    return (int(num_parts * bucket * per_row) + dict_bytes
            + int(counts.nbytes))
