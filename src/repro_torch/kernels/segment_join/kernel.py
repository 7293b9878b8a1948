"""ctypes bindings for the Hopper kernels in ``csrc/segment_join.cu``.

One wrapper per kernel.  Each checks the device, dtype, contiguity and shape
of its inputs and raises on anything the kernel does not take, allocates its
outputs and scratch with ``torch.empty``/``torch.zeros``, launches on
``torch.cuda.current_stream()``, raises if the launch reports a CUDA error,
and adds one to its launch counter (:func:`repro_torch.device.count_launch`).
The wrappers only take CUDA tensors; there is no fallback inside them (the
plain versions in :mod:`.ref` serve CPU tensors, chosen in :mod:`.ops`).

Kernels and the TPU kernels they replace
(``src/repro/kernels/segment_join/kernel.py``):

  * :func:`segment_sum` ← ``segment_sum_pallas``
  * :func:`radix_rank` ← ``radix_rank_pallas``
  * :func:`join_table_build` ← ``join_table_build_pallas``
  * :func:`join_table_probe` and :func:`join_table_probe_rows` ←
    ``join_table_probe_pallas``

:func:`segment_sum_route` is a test hook: the sums and the route the card
chose for them (it waits for the card).
"""
from __future__ import annotations

import ctypes

import torch

from ...device import (count_launch, device_guard, kernel_library,
                       stream_handle)

__all__ = ["segment_sum", "segment_sum_route", "radix_rank",
           "join_table_build", "join_table_probe", "join_table_probe_rows",
           "RADIX_TILE", "SUM_ROUTES"]

#: the TPU kernel's tile argument, kept in :func:`radix_rank`'s signature;
#: the Hopper kernel sorts whole columns and does not read it
RADIX_TILE = 16384

_INT_MAX = 2**31 - 1

#: the routes of :func:`segment_sum`, by the card's route word
#: (``SumState::route`` in ``csrc/segment_join.cu``): exact in any order
#: (one pass with atomics), the row-order chain over the runs of the ids as
#: they come, or over their stably grouped copy
SUM_ROUTES = {1: "exact", 2: "runs", 3: "grouped"}


def _lib() -> ctypes.CDLL:
    lib = kernel_library("segment_join")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_segment_sum_f64_scratch_bytes.argtypes = [ll, i]
        lib.repro_segment_sum_f64_scratch_bytes.restype = ll
        lib.repro_segment_sum_f64.argtypes = [p, p, ll, p, i, p, p]
        for fn in (lib.repro_segment_sum_route_offset,
                   lib.repro_segment_sum_state_bytes):
            fn.argtypes = []
            fn.restype = ll
        lib.repro_radix_rank_scratch_bytes.argtypes = [ll, i]
        lib.repro_radix_rank_scratch_bytes.restype = ll
        lib.repro_radix_rank.argtypes = [p, ll, i, p, p, p, p]
        lib.repro_join_table_build.argtypes = [p, p, ll, p, i, p]
        lib.repro_join_table_probe.argtypes = [p, ll, p, p, i, i, i, p, p, p]
        for fn in (lib.repro_segment_sum_f64, lib.repro_radix_rank,
                   lib.repro_join_table_build, lib.repro_join_table_probe):
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev}, "
                             f"{t.device}")
    return dev


def _size(v: int, what: str) -> int:
    v = int(v)
    if not 0 <= v <= _INT_MAX:
        raise ValueError(f"{what}={v} does not fit the kernel's int32 range")
    return v


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    count_launch(name)


def _segment_sum(seg_ids, values, num_segments):
    """Launch the segment sum; returns ``(sums, state)``, the state being
    the bytes after the sums in their zeroed allocation (``None`` when
    nothing was launched)."""
    _require(seg_ids, torch.int32, "seg_ids")
    _require(values, torch.float64, "values")
    if seg_ids.shape != values.shape:
        raise ValueError(f"seg_ids {tuple(seg_ids.shape)} and values "
                         f"{tuple(values.shape)} differ in length")
    dev = _same_device(seg_ids, values)
    S = _size(num_segments, "num_segments")
    n = seg_ids.shape[0]
    if n == 0 or S == 0:
        return torch.zeros(S, dtype=torch.float64, device=dev), None
    _size(n, "rows")
    lib = _lib()
    # the sums and, after them, the route state: zeroed by one launch
    state_words = -(-lib.repro_segment_sum_state_bytes() // 8)
    buf = torch.zeros(S + state_words, dtype=torch.float64, device=dev)
    scratch = torch.empty(lib.repro_segment_sum_f64_scratch_bytes(n, S),
                          dtype=torch.uint8, device=dev)
    with device_guard(dev):
        _launch("segment_sum", lib.repro_segment_sum_f64,
                seg_ids.data_ptr(), values.data_ptr(), n, buf.data_ptr(), S,
                scratch.data_ptr(), stream_handle(dev))
    return buf[:S], buf[S:]


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``sums[s] = Σ values[i]`` over ``seg_ids[i] == s`` (int32 ids, float64
    values); ids outside ``[0, num_segments)`` are dropped.  The result has
    the bits of :func:`.ref.segment_sum_ref` on the CPU (each segment summed
    in ascending row order from +0.0), on every run.

    The card picks the route itself, with no host sync.  Where the sum is
    exact in any order (:func:`.ref.sum_is_order_free_ref`: integer cents,
    counts), one pass adds each run piece into the output with atomics,
    sorted ids or not.  Otherwise each segment is one chain of adds in row
    order: over the ids as they come where no id is below the one before
    it (the GROUP BY's), else over a copy grouped stably by segment (the
    digit passes of :func:`radix_rank`), which contiguous segments in no
    order take too.  The grouping's kernels are launched, and its scratch
    allocated, on every call: the host does not know the route."""
    return _segment_sum(seg_ids, values, num_segments)[0]


def segment_sum_route(seg_ids: torch.Tensor, values: torch.Tensor,
                      num_segments: int):
    """:func:`segment_sum` and the route the card took for it, a key of
    :data:`SUM_ROUTES` (``None`` when nothing was launched).  Reading the
    route back waits for the card: for tests and the smoke run only."""
    out, state = _segment_sum(seg_ids, values, num_segments)
    if state is None:
        return out, None
    off = _lib().repro_segment_sum_route_offset()
    word = state.view(torch.int32)[off // 4]
    return out, SUM_ROUTES[int(word.item())]


def radix_rank(bucket_ids: torch.Tensor, num_buckets: int,
               tile: int = RADIX_TILE):
    """``(rank, counts)``: each row's stable rank within its bucket and the
    bucket histogram (int32); ids outside ``[0, num_buckets)`` get rank 0
    and are not counted.  ``tile`` is checked and not used (the kernel sorts
    the whole column)."""
    _require(bucket_ids, torch.int32, "bucket_ids")
    dev = bucket_ids.device
    B = _size(num_buckets, "num_buckets")
    _size(tile, "tile")
    n = _size(bucket_ids.shape[0], "rows")
    if n == 0 or B == 0:
        return (torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    lib = _lib()
    scratch = torch.empty(lib.repro_radix_rank_scratch_bytes(n, B),
                          dtype=torch.uint8, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    with device_guard(dev):
        _launch("radix_rank", lib.repro_radix_rank, bucket_ids.data_ptr(), n,
                B, scratch.data_ptr(), counts.data_ptr(), rank.data_ptr(),
                stream_handle(dev))
    return rank, counts


def join_table_build(bk: torch.Tensor, brow: torch.Tensor, domain_pad: int):
    """``(cnt, inv)`` over ``[domain_pad]`` slots (int32): build rows per
    code and the largest ``brow + 1`` (0 = empty slot); codes outside
    ``[0, domain_pad)`` are ignored.  The two are the column views of one
    zeroed ``[domain_pad, 2]`` table of (cnt, inv) pairs, which
    :func:`join_table_probe` reads with one gather a probe."""
    _require(bk, torch.int32, "bk")
    _require(brow, torch.int32, "brow")
    if bk.shape != brow.shape:
        raise ValueError("bk and brow differ in length")
    dev = _same_device(bk, brow)
    D = _size(domain_pad, "domain_pad")
    table = torch.zeros((D, 2), dtype=torch.int32, device=dev)
    n = bk.shape[0]
    if n > 0 and D > 0:
        with device_guard(dev):
            _launch("join_table_build", _lib().repro_join_table_build,
                    bk.data_ptr(), brow.data_ptr(), n, table.data_ptr(), D,
                    stream_handle(dev))
    return table[:, 0], table[:, 1]


def _pairs(cnt: torch.Tensor, inv: torch.Tensor) -> bool:
    """Whether ``(cnt, inv)`` are the column views of one ``[D, 2]`` table
    (:func:`join_table_build`'s) rather than two contiguous tables."""
    for t, what in ((cnt, "cnt"), (inv, "inv")):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected torch.int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{what}: expected a 1-D tensor")
    if cnt.shape != inv.shape:
        raise ValueError("cnt and inv differ in length")
    if cnt.is_contiguous() and inv.is_contiguous():
        return False
    if (cnt.stride(0) == 2 and inv.stride(0) == 2
            and inv.data_ptr() == cnt.data_ptr() + 4
            and cnt.data_ptr() % 8 == 0):
        return True
    raise ValueError("cnt and inv: expected two contiguous tables or the "
                     "column views of one [D, 2] table")


def _probe(pk, cnt, inv, bias: int):
    _require(pk, torch.int32, "pk")
    pairs = _pairs(cnt, inv)
    dev = _same_device(pk, cnt, inv)
    D = _size(cnt.shape[0], "domain_pad")
    n = pk.shape[0]
    cnt_p = torch.empty(n, dtype=torch.int32, device=dev)
    inv_p = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return cnt_p, inv_p
    with device_guard(dev):
        _launch("join_table_probe", _lib().repro_join_table_probe,
                pk.data_ptr(), n, cnt.data_ptr(), inv.data_ptr(), D,
                int(pairs), bias, cnt_p.data_ptr(), inv_p.data_ptr(),
                stream_handle(dev))
    return cnt_p, inv_p


def join_table_probe(pk: torch.Tensor, cnt: torch.Tensor, inv: torch.Tensor):
    """Per probe row ``(cnt[c], inv[c])`` (int32); codes outside
    ``[0, len(cnt))`` give 0.  ``cnt``/``inv``: :func:`join_table_build`'s
    views (one 8-byte gather a probe) or two contiguous tables."""
    return _probe(pk, cnt, inv, 0)


def join_table_probe_rows(pk: torch.Tensor, cnt: torch.Tensor,
                          inv: torch.Tensor):
    """Per probe row ``(cnt[c], inv[c] - 1)``: the probe count and the
    build row (−1 on a miss or a code outside ``[0, len(cnt))``), in the
    probe side's own row order, by the same kernel as
    :func:`join_table_probe`."""
    return _probe(pk, cnt, inv, -1)
