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
  * :func:`join_table_probe` ← ``join_table_probe_pallas``
"""
from __future__ import annotations

import ctypes

import torch

from ...device import (count_launch, device_guard, kernel_library,
                       stream_handle)

__all__ = ["segment_sum", "radix_rank", "join_table_build",
           "join_table_probe", "RADIX_TILE"]

#: the TPU kernel's tile argument, kept in :func:`radix_rank`'s signature;
#: the Hopper kernel sorts whole columns and does not read it
RADIX_TILE = 16384

_INT_MAX = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = kernel_library("segment_join")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_segment_sum_f64_scratch_bytes.argtypes = [ll, i]
        lib.repro_segment_sum_f64_scratch_bytes.restype = ll
        lib.repro_segment_sum_f64.argtypes = [p, p, ll, p, i, i, p, p]
        lib.repro_radix_rank_scratch_bytes.argtypes = [ll, i]
        lib.repro_radix_rank_scratch_bytes.restype = ll
        lib.repro_radix_rank.argtypes = [p, ll, i, p, p, p, p]
        lib.repro_join_table_build.argtypes = [p, p, ll, p, p, i, p]
        lib.repro_join_table_probe.argtypes = [p, ll, p, p, i, p, p, p]
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


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int, ids_sorted: bool = False) -> torch.Tensor:
    """``sums[s] = Σ values[i]`` over ``seg_ids[i] == s`` (int32 ids, float64
    values); ids outside ``[0, num_segments)`` are dropped.  Each segment is
    summed in ascending row order from +0.0, so the result has the bits of
    :func:`.ref.segment_sum_ref` on the CPU, on every run.  ``ids_sorted``
    says that each segment's rows are contiguous (the GROUP BY's ids, out of
    a cumsum over sorted keys): the caller knows it, and the kernel does
    not check it.  A wrong True gives wrong sums: each run of a segment
    writes its own sum over the segment's, and one of them stays.  Other ids are
    first grouped stably by segment (the digit passes of
    :func:`radix_rank`) into scratch."""
    _require(seg_ids, torch.int32, "seg_ids")
    _require(values, torch.float64, "values")
    if seg_ids.shape != values.shape:
        raise ValueError(f"seg_ids {tuple(seg_ids.shape)} and values "
                         f"{tuple(values.shape)} differ in length")
    dev = _same_device(seg_ids, values)
    S = _size(num_segments, "num_segments")
    out = torch.zeros(S, dtype=torch.float64, device=dev)
    n = seg_ids.shape[0]
    if n == 0 or S == 0:
        return out
    lib = _lib()
    scratch = None  # sorted ids need none
    if not ids_sorted:
        _size(n, "rows")
        scratch = torch.empty(lib.repro_segment_sum_f64_scratch_bytes(n, S),
                              dtype=torch.uint8, device=dev)
    with device_guard(dev):
        _launch("segment_sum", lib.repro_segment_sum_f64,
                seg_ids.data_ptr(), values.data_ptr(), n, out.data_ptr(), S,
                int(bool(ids_sorted)),
                None if scratch is None else scratch.data_ptr(),
                stream_handle(dev))
    return out


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
    ``[0, domain_pad)`` are ignored."""
    _require(bk, torch.int32, "bk")
    _require(brow, torch.int32, "brow")
    if bk.shape != brow.shape:
        raise ValueError("bk and brow differ in length")
    dev = _same_device(bk, brow)
    D = _size(domain_pad, "domain_pad")
    # both tables in one allocation, zeroed by one launch
    cnt, inv = torch.zeros((2, D), dtype=torch.int32, device=dev).unbind(0)
    n = bk.shape[0]
    if n == 0 or D == 0:
        return cnt, inv
    with device_guard(dev):
        _launch("join_table_build", _lib().repro_join_table_build,
                bk.data_ptr(), brow.data_ptr(), n, cnt.data_ptr(),
                inv.data_ptr(), D, stream_handle(dev))
    return cnt, inv


def join_table_probe(pk: torch.Tensor, cnt: torch.Tensor, inv: torch.Tensor):
    """Per probe row ``(cnt[c], inv[c])`` (int32); codes outside
    ``[0, len(cnt))`` give 0."""
    _require(pk, torch.int32, "pk")
    _require(cnt, torch.int32, "cnt")
    _require(inv, torch.int32, "inv")
    if cnt.shape != inv.shape:
        raise ValueError("cnt and inv differ in length")
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
                cnt_p.data_ptr(), inv_p.data_ptr(), stream_handle(dev))
    return cnt_p, inv_p
