"""Radix partitioning for sharded fused fragments (host-side, cached).

The sharded tensor path splits a fused Join→[Filter]→[Agg] fragment into
``num_parts`` co-partitions by a multiplicative hash of the join key, one
logical lane each, and places them on the devices in contiguous blocks
(:func:`repro_torch.distributed.sharding.partition_placement`): each
device holds its block of every partitioned column as one ``(block,
bucket)`` tensor whose row ``p`` holds the block's ``p``-th partition.
This module owns the host side of that contract:

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
    sampled content tokens and the placement, and bookkeeping is serialized by
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
Dictionaries ride next to the partitioned columns (one copy on each
device serves its partitions: uploaded once, copied from the first device
to the others, as the reference replicates them) and the sharded program
decodes at gather, same as the single-device fused path.

The host pass is the reference's, step for step, so every partitioned
column equals the reference's element by element.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import upload
from ..distributed.sharding import PartitionPlacement
from .codec_device import (DeviceColumnLayout, compress_enabled, dict_bucket,
                           encode_host, pad_dictionary)
from .relation import Relation, column_token

__all__ = [
    "PART_MIN_BUCKET",
    "partition_bucket",
    "partition_of",
    "partition_counts",
    "partition_skew",
    "get_partitioned_columns",
    "get_placed_columns",
    "pending_partition_bytes",
    "resident_partition_bytes",
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


def _upload(host_cols, counts, dicts_host, placement: PartitionPlacement):
    """Host→device placement of a partitioned layout: each device gets its
    block of rows of every ``(P, bucket)`` column as one tensor, so the
    sharded program consumes it with no per-call reshaping.  Dictionaries
    cross from the host once, to the first device, and are copied from
    there to every other device that decodes (the reference replicates
    them; the host-to-device bytes stay its own).  Returns one ``(cols,
    counts_dev, dicts_dev)`` per group."""
    first = placement.devices[0]
    dicts_first = {name: upload(d, first) for name, d in dicts_host.items()}
    copies = {first: dicts_first}
    blocks = []
    for dev, lo, hi in placement.groups:
        if dev not in copies:
            copies[dev] = {name: d.to(dev) for name, d in dicts_first.items()}
        blocks.append(({name: upload(buf[lo:hi], dev)
                        for name, buf in host_cols.items()},
                       upload(counts[lo:hi], dev), copies[dev]))
    return tuple(blocks)


def _single(device, num_parts: int) -> PartitionPlacement:
    """Every partition on one device, or a placement as it was given."""
    if isinstance(device, PartitionPlacement):
        return device
    return PartitionPlacement((torch.device(device),), (0, int(num_parts)))


def get_placed_columns(rel: Relation, key: str, sort_within: bool,
                       placement: PartitionPlacement):
    """Partitioned device columns for ``rel`` over ``placement``, cached on
    the instance.

    Returns ``(blocks, counts, bucket, uploaded_bytes, logical_bytes,
    layouts)``: ``blocks`` holds one ``(cols, counts_dev, dicts)`` per
    group of the placement, on its device: ``cols`` maps column name →
    ``(block, bucket)`` tensor (packed codes for compressed payloads),
    ``counts_dev`` the block's per-partition row counts, ``dicts`` maps
    ``dict``-encoded payload names to their dictionaries.  ``counts`` are
    every partition's row counts on the host, ``uploaded_bytes`` the
    physical H2D traffic this call actually paid, summed over the devices
    (0 on a warm hit — the serving-path contract), and ``logical_bytes``
    the same transfer priced at logical column width.  ``layouts`` maps
    name → :class:`~repro_torch.core.codec_device.DeviceColumnLayout`.
    Entries are keyed by the placement, so layouts of one table over
    other devices, or over the same devices in other blocks, coexist."""
    num_parts = placement.num_parts
    tokens = tuple((name, column_token(rel[name])) for name in rel.names)
    cache_key = (key, num_parts, bool(sort_within), placement.key)
    with _LOCK:
        cache = rel.__dict__.setdefault(_CACHE_ATTR, {})
        entry = cache.get(cache_key)
        if entry is not None and entry["tokens"] == tokens:
            _COUNTERS.hits += 1
            return (entry["blocks"], entry["counts"], entry["bucket"], 0, 0,
                    entry["layouts"])
        _COUNTERS.misses += 1
    host_cols, counts, bucket, layouts, dicts_host = _build_partitions(
        rel, key, num_parts, sort_within)
    blocks = _upload(host_cols, counts, dicts_host, placement)
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
            return (current["blocks"], current["counts"], current["bucket"],
                    uploaded, logical, current["layouts"])
        cache[cache_key] = {"tokens": tokens, "blocks": blocks,
                            "counts": counts, "bucket": bucket,
                            "layouts": layouts}
        _COUNTERS.h2d_bytes += uploaded
    return blocks, counts, bucket, uploaded, logical, layouts


def get_partitioned_columns(rel: Relation, key: str, num_parts: int,
                            sort_within: bool, device="cuda"):
    """Every partition of ``rel`` on one ``device``, through
    :func:`get_placed_columns` (the same cache entry as a one-group
    placement there).

    Returns ``(cols, counts_dev, counts, bucket, uploaded_bytes,
    logical_bytes, layouts, dicts)``: ``cols`` maps column name →
    ``(num_parts, bucket)`` tensor on ``device``, ``counts_dev`` the
    per-partition row counts as a ``(num_parts,)`` tensor on ``device``,
    ``dicts`` the ``dict``-encoded payloads' device dictionaries; the rest
    as :func:`get_placed_columns` returns them."""
    num_parts = int(num_parts)
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    (blocks, counts, bucket, uploaded, logical,
     layouts) = get_placed_columns(rel, key, sort_within,
                                   _single(device, num_parts))
    (cols, counts_dev, dicts), = blocks
    return (cols, counts_dev, counts, bucket, uploaded, logical, layouts,
            dicts)


def resident_partition_bytes(rel: Relation) -> Dict[str, int]:
    """Bytes of ``rel``'s cached partitioned layouts on each device, by
    device name: columns, counts and dictionaries, each tensor once."""
    out: Dict[str, int] = {}
    seen = set()
    with _LOCK:
        entries = [v for v in rel.__dict__.get(_CACHE_ATTR, {}).values()
                   if isinstance(v, dict)]
    for entry in entries:
        for cols, counts_dev, dicts in entry["blocks"]:
            for t in (*cols.values(), counts_dev, *dicts.values()):
                if id(t) not in seen:
                    seen.add(id(t))
                    name = str(t.device)
                    out[name] = out.get(name, 0) + t.numel() * t.element_size()
    return out


def pending_partition_bytes(rel: Relation, key: str, num_parts: int,
                            sort_within: bool, device="cuda") -> int:
    """H2D bytes :func:`get_placed_columns` would transfer right now,
    summed over the devices of ``device`` (a
    :class:`~repro_torch.distributed.sharding.PartitionPlacement`, or one
    device that holds every partition) — 0 when the partitioned layout is
    already resident there (the selector's cache-aware cost term,
    mirroring ``pending_upload_bytes``).  With compression on this prices
    the PACKED layout (narrow payload codes + dictionaries, uploaded once),
    so the selector sees the sharded candidate's true, cheaper transfer."""
    num_parts = int(num_parts)
    placement = _single(device, num_parts)
    tokens = tuple((name, column_token(rel[name])) for name in rel.names)
    with _LOCK:
        cache = rel.__dict__.get(_CACHE_ATTR)
        if cache is not None:
            entry = cache.get((key, num_parts, bool(sort_within),
                               placement.key))
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
