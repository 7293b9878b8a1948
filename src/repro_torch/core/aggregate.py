"""GROUP BY (hash aggregate) with dual execution paths.

The third classic linearizing operator after join and sort: the linear path
builds a hash table of groups (spilling to grouped partitions under
work_mem), the tensor path segment-reduces along the key axis (the same
dimension-preserving structure as the fused join-aggregate).  Semantics are
identical; the executor treats it as another deferred decision point.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .linear_engine import _next_pow2, _splitmix64, table_bytes_estimate
from .metrics import OpMetrics, SpillAccount, Timer
from .relation import Relation
from .spill import SpillManager

__all__ = ["group_aggregate_linear", "group_aggregate_tensor",
           "group_aggregate_device"]

_AGGS = ("sum", "count", "min", "max")


def _agg_inmem(rel: Relation, key: str, values: Dict[str, str]) -> Relation:
    keys = rel[key]
    uniq, inv = np.unique(keys, return_inverse=True)
    out: Dict[str, np.ndarray] = {key: uniq}
    for col, fn in values.items():
        v = rel[col]
        if fn == "sum":
            out[f"{fn}_{col}"] = np.bincount(inv, weights=v.astype(np.float64),
                                             minlength=len(uniq))
        elif fn == "count":
            out[f"{fn}_{col}"] = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
        elif fn in ("min", "max"):
            fill = np.inf if fn == "min" else -np.inf
            acc = np.full(len(uniq), fill)
            ufunc = np.minimum if fn == "min" else np.maximum
            ufunc.at(acc, inv, v.astype(np.float64))
            out[f"{fn}_{col}"] = acc
        else:
            raise ValueError(fn)
    return Relation(out)


def _merge_groups(parts: List[Relation], key: str, values: Dict[str, str]) -> Relation:
    merged = parts[0]
    for p in parts[1:]:
        merged = merged.concat(p)
    keys = merged[key]
    uniq, inv = np.unique(keys, return_inverse=True)
    out = {key: uniq}
    for col, fn in values.items():
        name = f"{fn}_{col}"
        v = merged[name]
        if fn in ("sum", "count"):
            out[name] = np.bincount(inv, weights=v, minlength=len(uniq))
        else:
            fill = np.inf if fn == "min" else -np.inf
            acc = np.full(len(uniq), fill)
            (np.minimum if fn == "min" else np.maximum).at(acc, inv, v)
            out[name] = acc
    return Relation(out)


def group_aggregate_linear(rel: Relation, key: str, values: Dict[str, str],
                           work_mem: int, mgr: SpillManager = None
                           ) -> Tuple[Relation, OpMetrics]:
    """Hash aggregate with work_mem discipline: when the group table would
    not fit, inputs hash-partition to disk and each partition aggregates
    independently (PostgreSQL's spill-to-disk hash aggregation)."""
    own = mgr is None
    mgr = mgr or SpillManager()
    spill = SpillAccount()
    peak = 0
    try:
        with Timer() as t:
            keys = rel[key].astype(np.int64)
            n_groups_est = min(len(rel), max(1, len(np.unique(
                keys[: min(len(keys), 65536)])) * max(1, len(keys) // 65536)))
            est = table_bytes_estimate(n_groups_est)
            if est <= work_mem or len(rel) <= 64:
                out = _agg_inmem(rel, key, values)
                peak = est
            else:
                fanout = min(64, max(2, _next_pow2(int(np.ceil(est / work_mem)))))
                spill.partition_passes += 1
                h = (_splitmix64(keys, salt=7) % np.uint64(fanout)).astype(np.int64)
                parts = []
                for f in range(fanout):
                    part = rel.take(np.nonzero(h == f)[0])
                    if len(part) == 0:
                        continue
                    path = mgr.write_relation(part, f"agg{f}", spill)
                    parts.append(path)
                peak = table_bytes_estimate(n_groups_est // fanout)
                results = []
                for path in parts:
                    part = mgr.read_relation(path, spill)
                    mgr.delete(path)
                    results.append(_agg_inmem(part, key, values))
                out = _merge_groups(results, key, values)
    finally:
        if own:
            mgr.cleanup()
    return out, OpMetrics(op="group_aggregate", path="linear",
                          rows_in=len(rel), rows_out=len(out),
                          wall_s=t.elapsed, spill=spill,
                          peak_working_set_bytes=peak)


def _group_reduce_impl(keys, valid, cols, fns, num_segments):
    """Device group-by core: factorize the key axis ON DEVICE (sort + run
    boundaries), then segment-reduce every aggregate column.

    ``valid`` masks physical rows that are not logical rows (the device-
    resident pipeline's capacity padding / filtered rows); masked rows carry
    zero weight and sink to the tail of the sorted key axis.  Output arrays
    are ``num_segments``-padded; the returned prefix mask selects the real
    groups.  No host transfer happens anywhere in here.  Sum and count go
    through :func:`~repro_torch.core.tensor_engine.segment_sum_dispatch`
    (the segment-sum kernel on a CUDA device, at any ``num_segments``);
    min and max are plain ``scatter_reduce``, as the reference leaves them
    to ``jax.ops.segment_min``/``segment_max``.
    """
    from .tensor_engine import segment_sum_dispatch

    n = keys.shape[0]
    dev = keys.device
    order = torch.argsort(keys, stable=True)
    if valid is None:
        vmask = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        # second stable pass on invalidity: masked rows sink to the tail
        # WITHOUT remapping their keys (a sentinel remap would collide with
        # real rows at the dtype extreme and merge segments)
        order = order[torch.argsort((~valid[order]).to(torch.uint8),
                                    stable=True)]
        vmask = valid[order]
    sk = keys[order]
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        boundary[1:] = sk[1:] != sk[:-1]
    # valid rows form a prefix, so within it `boundary` is exact
    newseg = boundary & vmask
    # masked rows inherit ids; weight 0
    seg = torch.cumsum(newseg.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_l = seg.clamp(min=0).long()
    nseg = newseg.sum()
    uniq = torch.full((num_segments,), torch.iinfo(keys.dtype).min,
                      dtype=keys.dtype, device=dev)
    uniq.scatter_reduce_(0, seg_l, torch.where(vmask, sk,
                                               torch.iinfo(keys.dtype).min),
                         reduce="amax", include_self=True)
    results = []
    for col, fn in zip(cols, fns):
        v = col.to(torch.float64)[order]
        # seg never decreases (a cumsum over the sorted keys): where the
        # sum is not exact in every order, the card chains its runs as they
        # come
        if fn == "sum":
            r = segment_sum_dispatch(torch.where(vmask, v, 0.0), seg,
                                     num_segments)
        elif fn == "count":
            r = segment_sum_dispatch(vmask.to(torch.float64), seg,
                                     num_segments)
        elif fn == "min":
            r = torch.full((num_segments,), float("inf"), dtype=torch.float64,
                           device=dev).scatter_reduce_(
                0, seg_l, torch.where(vmask, v, float("inf")), reduce="amin",
                include_self=True)
        elif fn == "max":
            r = torch.full((num_segments,), float("-inf"),
                           dtype=torch.float64, device=dev).scatter_reduce_(
                0, seg_l, torch.where(vmask, v, float("-inf")),
                reduce="amax", include_self=True)
        else:
            raise ValueError(fn)
        results.append(r)
    valid_out = torch.arange(num_segments, device=dev) < nseg
    return uniq, tuple(results), valid_out


def group_aggregate_device(rel, key: str, values: Dict[str, str]):
    """Device-resident GROUP BY: DeviceRelation → DeviceRelation, zero syncs.

    Factorization is a device sort; the output stays device-resident with
    its real group count carried as a prefix validity mask.
    """
    from .device_relation import DeviceRelation

    cols_in = tuple(rel.col(c) for c in values)
    fns = tuple(values.values())
    key_col = rel.columns[key]
    key_decode = None
    if key_col.decode is not None:
        # packed key column: factorize in the CODE domain.  Both codecs are
        # order-preserving (FOR is value−min, dict codes are sorted-unique
        # ranks), so sorting codes sorts values and segment boundaries are
        # identical — only the per-group representative needs decoding, one
        # O(groups) device op after the reduce instead of an O(rows) decode
        # before it.
        keys_dev = key_col.force_codes()
        key_decode = key_col.decode
    else:
        keys_dev = rel.col(key)
        if keys_dev.dtype.is_floating_point or keys_dev.dtype == torch.bool:
            # seed-compatible coercion: non-integer group keys truncate to
            # int64 (the segment machinery needs an integer coordinate axis)
            keys_dev = keys_dev.to(torch.int64)
    n = rel.num_physical_rows
    if n == 0:
        out_cols = {key: rel.col(key)}
        for col, agg in values.items():
            out_cols[f"{agg}_{col}"] = torch.zeros(0, dtype=torch.float64,
                                                   device=rel.device)
        return (DeviceRelation.from_arrays(out_cols),
                OpMetrics(op="group_aggregate", path="tensor", rows_in=0,
                          rows_out=0, wall_s=0.0, spill=SpillAccount()))
    with Timer() as t:
        uniq, results, valid_out = _group_reduce_impl(keys_dev, rel.valid,
                                                      cols_in, fns, n)
        if key_decode is not None:
            # decode-at-fetch for the group axis: garbage codes in invalid
            # segments decode to arbitrary (clamped) values, masked by the
            # valid_out prefix exactly like every other padded output
            uniq = key_decode(uniq)
        out_cols = {key: uniq}
        for (col, agg), r in zip(values.items(), results):
            out_cols[f"{agg}_{col}"] = r
        out = DeviceRelation.from_arrays(out_cols, valid=valid_out)
    peak = n * 8 * (2 + len(values))
    return out, OpMetrics(op="group_aggregate", path="tensor",
                          rows_in=n, rows_out=n,
                          wall_s=t.elapsed, spill=SpillAccount(),
                          peak_working_set_bytes=peak, host_syncs=0)


def group_aggregate_tensor(rel: Relation, key: str, values: Dict[str, str],
                           key_domain: int = None, device=None
                           ) -> Tuple[Relation, OpMetrics]:
    """Dimension-preserving aggregate: segment reductions along the key axis
    (static segment count) — no group hash table ever exists.

    Host-Relation API over :func:`group_aggregate_device`: lift, reduce on
    device, fetch."""
    from ..device import resolve_device, to_host
    from .device_relation import DeviceRelation

    dev = DeviceRelation.from_host(rel, resolve_device(device))
    with Timer() as t:
        out_dev, m = group_aggregate_device(dev, key, values)
        syncs = 1
        if out_dev.valid is not None:
            # group outputs are padded to the physical row count; fetch the
            # group count (scalar sync) and device-slice so the batched
            # result fetch is O(groups), not O(rows)
            nseg = int(to_host([out_dev.valid.sum()])[0])
            syncs = 2
            out_dev = DeviceRelation.from_arrays(
                {k: out_dev.col(k)[:nseg] for k in out_dev.names})
        out = out_dev.to_host()
    peak = rel.nbytes() + len(out) * 8 * (1 + len(values))
    return out, OpMetrics(op="group_aggregate", path="tensor",
                          rows_in=len(rel), rows_out=len(out),
                          wall_s=t.elapsed, spill=SpillAccount(),
                          peak_working_set_bytes=peak, host_syncs=syncs)
