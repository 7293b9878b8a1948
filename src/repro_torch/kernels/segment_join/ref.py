"""Plain PyTorch versions of the segment-sum, radix and hash-table kernels.

Each function computes exactly what its kernel in :mod:`.kernel` computes,
with library ops (``index_add_``, ``scatter_reduce_``, stable ``argsort``,
gathers).  The wrappers in :mod:`.ops` take these for tensors on the CPU;
for CUDA tensors they launch the kernels, and the tests and
``chip_smoke.py`` hold the two against each other.  The composite oracles
(:func:`radix_partition_ref`, :func:`radix_hash_probe_ref`) follow
``src/repro/kernels/segment_join/ref.py``.
"""
from __future__ import annotations

import torch

__all__ = ["segment_sum_ref", "radix_rank_ref", "join_table_build_ref",
           "join_table_probe_ref", "radix_partition_ref",
           "radix_hash_probe_ref"]


def _in_range(ids: torch.Tensor, hi: int) -> torch.Tensor:
    return (ids >= 0) & (ids < hi)


def segment_sum_ref(seg_ids: torch.Tensor, values: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """``sums[s] = Σ values[i]`` over ``seg_ids[i] == s``; ids outside
    ``[0, num_segments)`` are dropped.  Float64 in, float64 out."""
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    keep = _in_range(seg_ids, num_segments)
    seg = torch.where(keep, seg_ids, 0).long()
    return out.index_add_(0, seg, torch.where(keep, values, 0))


def radix_rank_ref(bucket_ids: torch.Tensor, num_buckets: int):
    """``(rank, counts)``: each row's stable rank within its bucket and the
    bucket histogram.  Ids outside ``[0, num_buckets)`` get rank 0 and are
    not counted."""
    n = bucket_ids.shape[0]
    dev = bucket_ids.device
    live = _in_range(bucket_ids, num_buckets)
    b = torch.where(live, bucket_ids, num_buckets).long()
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, b, torch.ones(n, dtype=torch.int32, device=dev))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    order = torch.argsort(b, stable=True)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    pos[order] = torch.arange(n, dtype=torch.int32, device=dev)
    rank = torch.where(live, pos - offsets[b], 0).to(torch.int32)
    return rank, counts[:num_buckets]


def join_table_build_ref(bk: torch.Tensor, brow: torch.Tensor,
                         domain_pad: int):
    """``(cnt, inv)`` over ``[domain_pad]`` slots: build rows per code and
    the largest ``brow + 1`` (0 = empty); codes outside the table are
    ignored."""
    dev = bk.device
    live = _in_range(bk, domain_pad)
    code = torch.where(live, bk, domain_pad).long()
    cnt = torch.zeros(domain_pad + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, code, live.to(torch.int32))
    inv = torch.zeros(domain_pad + 1, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(0, code, torch.where(live, brow + 1, 0).to(torch.int32),
                        reduce="amax", include_self=True)
    return cnt[:domain_pad], inv[:domain_pad]


def join_table_probe_ref(pk: torch.Tensor, cnt: torch.Tensor,
                         inv: torch.Tensor):
    """Per probe row ``(cnt[c], inv[c])``; codes outside the table give 0."""
    live = _in_range(pk, cnt.shape[0])
    code = torch.where(live, pk, 0).long()
    zero = torch.zeros((), dtype=torch.int32, device=pk.device)
    return (torch.where(live, cnt[code], zero),
            torch.where(live, inv[code], zero))


def radix_partition_ref(bucket_ids: torch.Tensor, num_buckets: int):
    """Stable partition-major positions + histogram (argsort oracle)."""
    n = bucket_ids.shape[0]
    dev = bucket_ids.device
    b = bucket_ids.long()
    order = torch.argsort(b, stable=True)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    dest[order] = torch.arange(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=dev)
    counts.index_add_(0, b, torch.ones(n, dtype=torch.int32, device=dev))
    return dest, counts


def radix_hash_probe_ref(bk: torch.Tensor, pk: torch.Tensor, domain: int):
    """Scatter-table oracle with the kernel's tie rule (the largest build row
    id landing on a slot wins) and its empty-side contract (``has_dup`` is
    False when either side is empty).  Codes lie in ``[0, domain]``."""
    nb, np_ = bk.shape[0], pk.shape[0]
    dev = pk.device
    if nb == 0 or np_ == 0:
        cnt_p = torch.zeros(np_, dtype=torch.int32, device=dev)
        return cnt_p, cnt_p - 1, torch.zeros((), dtype=torch.bool, device=dev)
    brow = torch.arange(nb, dtype=torch.int32, device=dev)
    cnt, inv = join_table_build_ref(bk.to(torch.int32), brow, domain + 1)
    cnt_p, inv_p = join_table_probe_ref(pk.to(torch.int32), cnt, inv)
    has_dup = (cnt[:domain].max() > 1 if domain
               else torch.zeros((), dtype=torch.bool, device=dev))
    return cnt_p, inv_p - 1, has_dup
