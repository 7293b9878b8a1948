"""Segment sum, radix partition and radix hash probe over torch tensors.

The contracts are those of ``src/repro/kernels/segment_join/ops.py``.  Each
op picks its implementation by the device of the tensor it is given: a CUDA
tensor launches the hand-written kernels of :mod:`.kernel` (or raises), a
CPU tensor takes the plain versions of :mod:`.ref`.  There is no size gate:
the TPU kernels stopped at 4096 segments because of their one-hot
``[tile, segments]`` block, and the direct-addressed Hopper kernels have no
such limit.  Float64 stays float64 (the TPU path's downcast to float32 at
``ops.py:48-49`` of the reference is not carried over).

:func:`radix_hash_probe` is the full radix-join probe: the build side is
radix-ordered by the top bits of its int32 codes (:func:`radix_partition`)
and the table built in that order; the probe side is probed in its own row
order (:func:`join_table_probe_rows`, one launch), since the probe's
outputs do not depend on the order the probes run in.  The join cores in
``core/fused.py`` consume it through ``tensor_engine``'s dispatch.
"""
from __future__ import annotations

import torch

from . import kernel as _k
from . import ref as _ref

__all__ = ["segment_sum", "join_aggregate_kernel", "radix_rank",
           "radix_partition", "radix_hash_probe", "join_table_build",
           "join_table_probe", "join_table_probe_rows", "probe_block_size"]

#: the largest bucket count :func:`radix_hash_probe` lets its radix pass use
#: (a 128 KB per-tile histogram in shared memory)
MAX_PROBE_BUCKETS = 1 << 15


def _cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``sums[s] = Σ values[i]`` over ``seg_ids[i] == s``, in float64, each
    segment summed in ascending row order (the reference's bits).  The
    card picks its route from the data (:func:`.kernel.segment_sum`): an
    exact sum in any order, or the chain over ids that never decrease, or
    over a stably grouped copy."""
    seg = seg_ids.to(torch.int32).contiguous()
    vals = values.to(torch.float64).contiguous()
    if _cuda(seg):
        return _k.segment_sum(seg, vals, num_segments)
    return _ref.segment_sum_ref(seg, vals, num_segments)


def join_aggregate_kernel(build_keys, build_vals, probe_keys, probe_vals,
                          num_segments: int):
    """Σ over (virtual) join pairs of b·p — join output never materialized."""
    sb = segment_sum(build_keys, build_vals, num_segments)
    sp = segment_sum(probe_keys, probe_vals, num_segments)
    cb = segment_sum(build_keys, torch.ones_like(build_vals,
                                                 dtype=torch.float64),
                     num_segments)
    cp = segment_sum(probe_keys, torch.ones_like(probe_vals,
                                                 dtype=torch.float64),
                     num_segments)
    return {"count": torch.dot(cb, cp), "sum_prod": torch.dot(sb, sp),
            "sum_add": torch.dot(sb, cp) + torch.dot(cb, sp)}


def radix_rank(bucket_ids: torch.Tensor, num_buckets: int):
    """``(rank, counts)``: stable within-bucket ranks + histogram (int32);
    ids outside ``[0, num_buckets)`` get rank 0 and are not counted."""
    b = bucket_ids.to(torch.int32).contiguous()
    if _cuda(b):
        return _k.radix_rank(b, num_buckets)
    return _ref.radix_rank_ref(b, num_buckets)


def join_table_build(bk: torch.Tensor, brow: torch.Tensor, domain_pad: int):
    bk = bk.to(torch.int32).contiguous()
    brow = brow.to(torch.int32).contiguous()
    if _cuda(bk):
        return _k.join_table_build(bk, brow, domain_pad)
    return _ref.join_table_build_ref(bk, brow, domain_pad)


def join_table_probe(pk: torch.Tensor, cnt: torch.Tensor, inv: torch.Tensor):
    pk = pk.to(torch.int32).contiguous()
    if _cuda(pk):
        return _k.join_table_probe(pk, cnt, inv)
    return _ref.join_table_probe_ref(pk, cnt, inv)


def join_table_probe_rows(pk: torch.Tensor, cnt: torch.Tensor,
                          inv: torch.Tensor):
    """``(cnt[c], inv[c] - 1)`` per probe row in its own order: the probe
    count and the build row, −1 on a miss or outside the table."""
    pk = pk.to(torch.int32).contiguous()
    if _cuda(pk):
        return _k.join_table_probe_rows(pk, cnt, inv)
    return _ref.join_table_probe_rows_ref(pk, cnt, inv)


def radix_partition(bucket_ids: torch.Tensor, num_buckets: int):
    """Stable partition positions: ``(dest, counts)`` where ``dest[i]`` is
    row ``i``'s position in partition-major order (rows of the same bucket
    keep their relative order) and ``counts`` is the bucket histogram.
    ``bucket_ids`` must lie in ``[0, num_buckets)``."""
    n = bucket_ids.shape[0]
    dev = bucket_ids.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(num_buckets, dtype=torch.int32, device=dev))
    b = bucket_ids.to(torch.int32).contiguous()
    rank, counts = radix_rank(b, num_buckets)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # out-of-contract ids must not become an out-of-range gather (a device
    # assert on CUDA); they get a clamped, meaningless position instead
    dest = offsets[b.clamp(0, num_buckets - 1).long()] + rank
    return dest, counts


def _order(arr: torch.Tensor, dest: torch.Tensor):
    """Apply partition positions: ``out[dest[i]] = arr[i]``; also returns
    the inverse permutation (original row of each ordered slot)."""
    n = arr.shape[0]
    inv = torch.empty(n, dtype=torch.int32, device=arr.device)
    inv[dest.long()] = torch.arange(n, dtype=torch.int32, device=arr.device)
    return arr[inv.long()], inv


def probe_block_size(domain: int, dblk: int = 512) -> int:
    """Codes per radix bucket for a probe over ``[0, domain]``: the
    reference's 512, doubled until the bucket count fits
    :data:`MAX_PROBE_BUCKETS`.  The probe's outputs do not depend on it."""
    while -(-(domain + 1) // dblk) > MAX_PROBE_BUCKETS:
        dblk *= 2
    return dblk


def radix_hash_probe(bk: torch.Tensor, pk: torch.Tensor, domain: int,
                     dblk: int = None):
    """Radix-partitioned hash-join probe in the int32 code domain.

    ``bk``/``pk`` are codes in ``[0, domain]`` — slot ``domain`` is the
    dead/padding slot of the dense-core convention (callers mask dead
    probes with their own liveness predicate).

    Returns ``(cnt_p, build_row, has_dup)``: per probe row the number of
    matching build rows and the largest matching build-row id (−1 on
    miss), plus a 0-d bool tensor saying whether any *live* slot holds more
    than one build row (the caller's retry-to-sorted-core signal).  Nothing
    here synchronises with the host.
    """
    nb, np_ = bk.shape[0], pk.shape[0]
    dev = pk.device
    if nb == 0 or np_ == 0:
        cnt_p = torch.zeros(np_, dtype=torch.int32, device=dev)
        return cnt_p, cnt_p - 1, torch.zeros((), dtype=torch.bool, device=dev)
    dblk = probe_block_size(domain) if dblk is None else dblk
    nblocks = -(-(domain + 1) // dblk)
    dpad = nblocks * dblk
    shift = dblk.bit_length() - 1          # log2(dblk), dblk a power of two
    bk = bk.to(torch.int32).contiguous()
    # 1. radix-order the build side by domain block (top code bits) and
    # build the table in that order
    bdest, _ = radix_partition(bk >> shift, nblocks)
    bk_ord, brow = _order(bk, bdest)
    cnt_t, inv_t = join_table_build(bk_ord, brow, dpad)
    # 2. probe in the probe side's own row order: count and build row
    cnt_p, build_row = join_table_probe_rows(pk, cnt_t, inv_t)
    has_dup = (cnt_t[:domain].max() > 1 if domain
               else torch.zeros((), dtype=torch.bool, device=dev))
    return cnt_p, build_row, has_dup
