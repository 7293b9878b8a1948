"""The TENSOR execution path (the paper's contribution, §III–IV), in PyTorch.

Dimension preservation on an accelerator means *static-shape, axis-explicit*
programs instead of pointer-chasing linearized intermediates:

  * ``tensor_join`` — equi-join as **sorted coordinate alignment**: the join
    key stays an explicit coordinate axis; build rows are ordered along it
    (``argsort``), probe coordinates are aligned with ``searchsorted`` and
    match ranges expanded by segment arithmetic into a *statically sized*
    index space (capacity + validity mask).  No hash table is materialized;
    memory traffic is deterministic O(N log N).

  * ``tensor_join_aggregate`` — the strongest form of delayed materialization:
    for join-then-aggregate queries the join output is **never produced**;
    both relations are segment-reduced along the shared key axis and the
    aggregate is a contraction over that axis.

  * ``tensor_sort`` — multi-key sort performed *step-wise along key axes*
    (stable LSD passes), exactly §IV.B.

Device residency (this layer's contract): join capacity is computed *on
device* by the same sort+searchsorted the join itself uses, and the only
device→host traffic a per-operator call pays is one scalar match count plus
one batched result fetch.  The ``*_device`` variants take and return
:class:`DeviceRelation` and pay *zero* syncs (or one scalar when a join must
discover its capacity), deferring all materialization to the query root.
Capacities are padded to powers of two.

Kernel dispatch follows the tensor's device: :func:`segment_sum_dispatch`,
:func:`radix_hash_probe_dispatch` and :func:`sort_perm_device` launch the
hand-written CUDA kernels (:mod:`repro_torch.kernels.segment_join`,
:mod:`repro_torch.kernels.multikey_sort`) for CUDA tensors and take their
plain PyTorch versions for CPU tensors, at every size.  The fused
fragment's sort (``fused.py``) keeps :func:`_lex_perm`'s ``torch.sort``
passes, as the reference keeps ``lax.sort`` there.  Relational payloads
are 64-bit (SQL bigint) and every dtype here is stated explicitly: a float
literal in PyTorch would otherwise be float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_host, upload
from .codec_device import SIGNED_VIEW
from .device_relation import DeviceColumn, DeviceRelation
from .metrics import OpMetrics, SpillAccount, Timer
from .relation import Relation

__all__ = [
    "tensor_join",
    "tensor_join_aggregate",
    "tensor_sort",
    "tensor_join_device",
    "tensor_sort_device",
    "join_capacity",
    "aligned_join_indices",
    "capacity_bucket",
    "sort_perm_device",
    "segment_sum_dispatch",
    "radix_hash_probe_dispatch",
]

# Distinct sentinels so masked-out build rows can never meet masked-out probe
# rows at the same key value.  Relations whose key domain includes these two
# extreme int64 values are not supported by the masked device join (documented
# contract; SQL bigint workloads never reach them).
_BUILD_DEAD_KEY = -(2**62) - 11
_PROBE_DEAD_KEY = -(2**62) - 22


def _next_pow2(n: int) -> int:
    return 1 << max(4, int(math.ceil(math.log2(max(1, n)))))


def capacity_bucket(n: int) -> int:
    """Power-of-two shape bucket: the static capacity of a join's index
    space.  Nearby match counts land on the same bucket."""
    return _next_pow2(max(1, n))


# ---------------------------------------------------------------------------
# Kernel dispatch: by the tensor's device
# ---------------------------------------------------------------------------

def segment_sum_dispatch(values: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Segment sum in float64, each segment in row order: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors
    (:func:`repro_torch.kernels.segment_join.ops.segment_sum`).  The card
    picks its route from the data, with no host sync."""
    from ..kernels.segment_join.ops import segment_sum
    return segment_sum(seg_ids, values, num_segments)


def radix_hash_probe_dispatch(bk_codes: torch.Tensor, pk_codes: torch.Tensor,
                              domain: int):
    """Dense-domain hash-probe core: the radix join of
    :func:`repro_torch.kernels.segment_join.ops.radix_hash_probe`.

    Codes lie in ``[0, domain]`` with slot ``domain`` as the dead/padding
    slot; the result is ``(cnt_p, build_row, has_dup)`` — per probe row the
    number of matching build rows and the largest matching build-row id
    (−1 on miss), plus whether any live slot collides (the caller's
    retry-to-sorted-core signal).  CUDA tensors run the kernels, CPU tensors
    their plain versions."""
    from ..kernels.segment_join.ops import radix_hash_probe
    return radix_hash_probe(bk_codes.to(torch.int32),
                            pk_codes.to(torch.int32), domain)


# ---------------------------------------------------------------------------
# Join: sorted coordinate alignment
# ---------------------------------------------------------------------------

def _join_plan(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """Shared device planning stage: ONE sort + searchsorted produces both the
    exact match count (the capacity signal) and the alignment arrays the join
    expansion reuses."""
    order = torch.argsort(build_keys, stable=True)
    sorted_keys = build_keys[order].contiguous()
    pk = probe_keys.contiguous()
    left = torch.searchsorted(sorted_keys, pk)
    right = torch.searchsorted(sorted_keys, pk, right=True)
    counts = right - left
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    if counts.shape[0]:
        total = ends[-1]
    else:
        total = torch.zeros((), dtype=torch.int64, device=ends.device)
    return order, left, starts, ends, total


def _expand_join(order, left, starts, ends, capacity: int):
    n_build = order.shape[0]
    n_probe = ends.shape[0]
    dev = ends.device
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    # which probe row does output slot s belong to?
    probe_idx = torch.searchsorted(ends.contiguous(), slot, right=True)
    probe_idx_c = torch.clamp(probe_idx, max=max(n_probe - 1, 0))
    offset = slot - starts[probe_idx_c]
    build_pos = left[probe_idx_c] + offset
    build_idx = order[torch.clamp(build_pos, 0, max(n_build - 1, 0))]
    total = (ends[-1] if n_probe
             else torch.zeros((), dtype=torch.int64, device=dev))
    valid = slot < total
    return build_idx, probe_idx_c, valid


def aligned_join_indices(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                         capacity: int):
    """Core dimension-preserving equi-join.

    Returns ``(build_idx, probe_idx, valid, total)`` where the first two are
    ``capacity``-sized gather indices into the original relations, ``valid``
    masks real matches, and ``total`` is the exact match count (callers can
    detect capacity overflow as ``total > capacity``).
    """
    order, left, starts, ends, total = _join_plan(build_keys, probe_keys)
    build_idx, probe_idx, valid = _expand_join(order, left, starts, ends,
                                               capacity)
    return build_idx, probe_idx, valid, total


def join_capacity(build_keys, probe_keys, device=None) -> int:
    """Exact match count, computed ON DEVICE by the join's own planning stage;
    only the scalar count crosses to the host."""
    dev = resolve_device(device)
    bk = torch.as_tensor(np.asarray(build_keys, dtype=np.int64), device=dev)
    pk = torch.as_tensor(np.asarray(probe_keys, dtype=np.int64), device=dev)
    if bk.shape[0] == 0 or pk.shape[0] == 0:
        return 0
    *_, total = _join_plan(bk, pk)
    return int(to_host([total])[0])


def tensor_join(
    build: Relation,
    probe: Relation,
    key: str,
    capacity: Optional[int] = None,
    device=None,
) -> Tuple[Relation, OpMetrics]:
    """Tensor-path equi-join producing the same schema as the linear path.

    Host-Relation convenience API: internally runs the device-resident join
    and pays exactly two host syncs — the scalar match count (capacity
    discovery + overflow check) and one batched result fetch.
    """
    dev = resolve_device(device)
    bk = np.asarray(build[key], dtype=np.int64)
    pk = np.asarray(probe[key], dtype=np.int64)
    if len(bk) == 0 or len(pk) == 0:
        out = {name: col[:0] for name, col in probe.columns.items()}
        out.update({f"b_{n}": c[:0] for n, c in build.columns.items() if n != key})
        return Relation(out), OpMetrics(
            op="hash_join", path="tensor", rows_in=len(build) + len(probe),
            rows_out=0, wall_s=0.0, spill=SpillAccount())
    with Timer() as t:
        order, left, starts, ends, total = _join_plan(upload(bk, dev),
                                                      upload(pk, dev))
        n = int(to_host([total])[0])  # host sync #1: one scalar, no data
        if capacity is None:
            capacity = capacity_bucket(n)
        elif n > capacity:
            raise ValueError(f"capacity {capacity} < exact match count {n}")
        build_idx, probe_idx, _valid = _expand_join(order, left, starts, ends,
                                                    capacity)
        b_idx = build_idx[:n]
        p_idx = probe_idx[:n]
        # Late materialization: gather payload columns ON DEVICE, only valid
        # rows, then fetch everything in one batched transfer.
        out_dev: Dict[str, torch.Tensor] = {}
        for name, col in probe.columns.items():
            out_dev[name] = upload(col, dev)[p_idx]
        for name, col in build.columns.items():
            if name == key:
                continue
            out_dev[f"b_{name}"] = upload(col, dev)[b_idx]
        if not out_dev:
            out_dev[key] = upload(probe[key], dev)[p_idx]
        names = list(out_dev)
        fetched = to_host([out_dev[k] for k in names])  # host sync #2
        result = Relation({k: np.array(v) for k, v in zip(names, fetched)})
    peak = (
        bk.nbytes * 3  # keys + order + sorted copy
        + pk.nbytes * 3  # searchsorted operands
        + capacity * 8 * 3  # index space
    )
    metrics = OpMetrics(
        op="hash_join",
        path="tensor",
        rows_in=len(build) + len(probe),
        rows_out=len(result),
        wall_s=t.elapsed,
        spill=SpillAccount(),  # structurally zero: no spill regime exists
        peak_working_set_bytes=peak,
        host_syncs=2,
        # materializing host API: every input column crosses to the device
        # per call (the cached executor paths report 0 when warm)
        h2d_bytes=build.nbytes() + probe.nbytes(),
    )
    return result, metrics


def tensor_join_device(
    build: DeviceRelation,
    probe: DeviceRelation,
    key: str,
    capacity: Optional[int] = None,
) -> Tuple[DeviceRelation, OpMetrics]:
    """Device-resident equi-join: payload columns never move.

    The output :class:`DeviceRelation` carries *gather indices* into the
    input relations' base columns (late materialization) plus a validity
    mask over the capacity-padded index space.  Host traffic: one scalar
    match count.
    """
    dev = probe.device
    if build.num_physical_rows == 0 or probe.num_physical_rows == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        cols = {name: c.take_lazy(empty) for name, c in probe.columns.items()}
        cols.update({f"b_{name}": c.take_lazy(empty)
                     for name, c in build.columns.items() if name != key})
        if not cols:
            cols[key] = probe.columns[key].take_lazy(empty)
        return DeviceRelation(cols), OpMetrics(
            op="hash_join", path="tensor",
            rows_in=len(build) + len(probe), rows_out=0, wall_s=0.0,
            spill=SpillAccount())
    bk = build.col(key).to(torch.int64)
    pk = probe.col(key).to(torch.int64)
    # masked-out input rows must never match: move them to dead key values
    if build.valid is not None:
        bk = torch.where(build.valid, bk, _BUILD_DEAD_KEY)
    if probe.valid is not None:
        pk = torch.where(probe.valid, pk, _PROBE_DEAD_KEY)
    with Timer() as t:
        order, left, starts, ends, total = _join_plan(bk, pk)
        # scalar sync: the capacity / overflow signal.  Even with an explicit
        # capacity the count must be verified — silently truncating the join
        # would corrupt results.
        n = int(to_host([total])[0])
        syncs = 1
        if capacity is None:
            capacity = capacity_bucket(n)
        elif n > capacity:
            raise ValueError(f"capacity {capacity} < exact match count {n}")
        build_idx, probe_idx, valid = _expand_join(order, left, starts, ends,
                                                   capacity)
        cols: Dict[str, DeviceColumn] = {}
        for name, c in probe.columns.items():
            cols[name] = c.take_lazy(probe_idx)
        for name, c in build.columns.items():
            if name == key:
                continue
            cols[f"b_{name}"] = c.take_lazy(build_idx)
        if not cols:
            cols[key] = probe.columns[key].take_lazy(probe_idx)
        out = DeviceRelation(cols, valid=valid)
    metrics = OpMetrics(
        op="hash_join",
        path="tensor",
        rows_in=len(build) + len(probe),
        rows_out=capacity,  # physical (padded) rows; logical count is masked
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=(bk.numel() * 8 * 3 + pk.numel() * 8 * 3
                                + capacity * 8 * 3),
        host_syncs=syncs,
    )
    return out, metrics


# ---------------------------------------------------------------------------
# Fused join + aggregate (join output never materialized)
# ---------------------------------------------------------------------------

# Both relations' values are contracted at ONE explicit dtype.
_AGG_DTYPE = torch.float64


def _join_aggregate(build_keys, build_vals, probe_keys, probe_vals,
                    num_segments: int):
    seg_b = segment_sum_dispatch(build_vals, build_keys, num_segments)
    cnt_b = segment_sum_dispatch(torch.ones_like(build_vals), build_keys,
                                 num_segments)
    seg_p = segment_sum_dispatch(probe_vals, probe_keys, num_segments)
    cnt_p = segment_sum_dispatch(torch.ones_like(probe_vals), probe_keys,
                                 num_segments)
    # SUM over join pairs of (b_val + p_val) decomposes along the key axis:
    #   sum_k [ cnt_p[k]*seg_b[k] + cnt_b[k]*seg_p[k] ]
    # and SUM of products contracts directly:  sum_k seg_b[k]*seg_p[k].
    sum_pairs = torch.dot(cnt_b, cnt_p)
    sum_add = torch.dot(seg_b, cnt_p) + torch.dot(cnt_b, seg_p)
    sum_prod = torch.dot(seg_b, seg_p)
    return sum_pairs, sum_add, sum_prod


def tensor_join_aggregate(
    build: Relation,
    probe: Relation,
    key: str,
    build_val: str,
    probe_val: str,
    key_domain: int,
    device=None,
) -> Tuple[dict, OpMetrics]:
    """SUM-style aggregates over the join result WITHOUT materializing it.

    Returns {count, sum_add, sum_prod} == aggregates over the (virtual) join
    of ``build ⋈ probe``: pair count, Σ(b+p), Σ(b·p), in float64.
    """
    dev = resolve_device(device)
    with Timer() as t:
        pairs, s_add, s_prod = _join_aggregate(
            upload(np.asarray(build[key], np.int32), dev),
            upload(np.asarray(build[build_val], np.float64), dev),
            upload(np.asarray(probe[key], np.int32), dev),
            upload(np.asarray(probe[probe_val], np.float64), dev),
            key_domain,
        )
        pairs, s_add, s_prod = to_host([pairs, s_add, s_prod])
        out = {
            "count": float(pairs),
            "sum_add": float(s_add),
            "sum_prod": float(s_prod),
        }
    metrics = OpMetrics(
        op="join_aggregate",
        path="tensor",
        rows_in=len(build) + len(probe),
        rows_out=1,
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=key_domain * 4 * 4 + build.nbytes() + probe.nbytes(),
        host_syncs=1,
        h2d_bytes=(build[key].nbytes + build[build_val].nbytes
                   + probe[key].nbytes + probe[probe_val].nbytes),
    )
    return out, metrics


# ---------------------------------------------------------------------------
# Sort: step-wise multi-key (stable LSD passes over key axes)
# ---------------------------------------------------------------------------

def _order_key(col: torch.Tensor) -> torch.Tensor:
    """``col`` as a key of the same order that every device op takes.

    PyTorch on CUDA has no gather, ``where`` or comparison for
    uint16/32/64, so those map to a signed dtype of the same order first,
    through a same-width view (``codec_device.SIGNED_VIEW``): uint16 to
    int32 and uint32 to int64 (the bits widened without the sign), uint64
    to int64 with the sign bit flipped.  bool becomes uint8 (torch sorts no
    bool tensors); every other dtype is returned as it is."""
    if col.dtype == torch.bool:
        return col.to(torch.uint8)
    same = SIGNED_VIEW.get(col.dtype)
    if same is None:
        return col
    if col.dtype == torch.uint64:
        return col.view(same) ^ torch.iinfo(torch.int64).min
    wide = torch.int32 if col.dtype == torch.uint16 else torch.int64
    return col.view(same).to(wide) & ((1 << (8 * col.element_size())) - 1)


def _lex_perm(key_cols, n: int, device) -> torch.Tensor:
    """Stable lexicographic permutation over ``key_cols`` (most significant
    first): stable LSD passes, least-significant key first, so stability
    makes the composition lexicographic.  Unsigned keys are mapped by
    :func:`_order_key` before any gather."""
    perm = torch.arange(n, device=device)
    for col in reversed(key_cols):
        col = _order_key(col)
        perm = perm[torch.sort(col[perm], stable=True).indices]
    return perm


def sort_perm_device(key_cols: Tuple[torch.Tensor, ...],
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int64 sort permutation over key axes (most significant first):
    stable LSD radix passes, one per key column, then one on validity so
    masked rows sink to the tail.  CUDA tensors launch the multi-key sort
    kernel (:mod:`repro_torch.kernels.multikey_sort`) for every key dtype,
    CPU tensors take its plain version."""
    from ..kernels.multikey_sort.ops import sort_perm
    return sort_perm(tuple(key_cols), valid)


def tensor_sort(
    rel: Relation, keys: Sequence[str], device=None,
) -> Tuple[Relation, OpMetrics]:
    """Tensor-path multi-key sort: per-axis stable passes, no key packing.

    Host-Relation API: permutation *and* payload gathers run on device; one
    batched fetch brings the result back."""
    dev = resolve_device(device)
    cols = {k: upload(v, dev) for k, v in rel.columns.items()}
    with Timer() as t:
        perm = sort_perm_device(tuple(cols[k] for k in keys))
        names = list(cols)
        fetched = to_host([cols[k][perm] for k in names])
        out = Relation({k: np.array(v) for k, v in zip(names, fetched)})
    peak = rel.nbytes() + len(rel) * 8 * 2
    metrics = OpMetrics(
        op="sort",
        path="tensor",
        rows_in=len(rel),
        rows_out=len(out),
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=peak,
        host_syncs=1,
        h2d_bytes=rel.nbytes(),
    )
    return out, metrics


def tensor_sort_device(
    rel: DeviceRelation, keys: Sequence[str]
) -> Tuple[DeviceRelation, OpMetrics]:
    """Device-resident multi-key sort: zero host syncs.

    Computes the permutation on device and composes it into the relation's
    pending gather indices — payload columns are not touched."""
    key_cols = tuple(rel.col(k) for k in keys)
    with Timer() as t:
        perm = sort_perm_device(key_cols, valid=rel.valid)
        out = rel.take_lazy(perm)
    peak = sum(c.element_size() for c in key_cols) * len(rel) + len(rel) * 8 * 2
    metrics = OpMetrics(
        op="sort",
        path="tensor",
        rows_in=len(rel),
        rows_out=len(rel),
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=peak,
        host_syncs=0,
    )
    return out, metrics
