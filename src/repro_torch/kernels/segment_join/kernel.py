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

from ...device import count_launch, kernel_library

__all__ = ["segment_sum", "radix_rank", "join_table_build",
           "join_table_probe", "RADIX_TILE"]

#: rows per tile of the radix rank kernel: a tile's histogram row is as many
#: bytes as 4 x buckets, so at the main path's 16,385 buckets the histogram
#: matrix stays near the size of the ids themselves (see the kernel's note)
RADIX_TILE = 16384

_INT_MAX = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = kernel_library("segment_join")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_segment_sum_f64.argtypes = [p, p, ll, p, i, p]
        lib.repro_radix_rank.argtypes = [p, ll, i, i, p, p, p, p]
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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``sums[s] = Σ values[i]`` over ``seg_ids[i] == s`` (int32 ids, float64
    values); ids outside ``[0, num_segments)`` are dropped."""
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
    with torch.cuda.device(dev):
        _launch("segment_sum", _lib().repro_segment_sum_f64,
                seg_ids.data_ptr(), values.data_ptr(), n, out.data_ptr(), S,
                _stream(dev))
    return out


def radix_rank(bucket_ids: torch.Tensor, num_buckets: int,
               tile: int = RADIX_TILE):
    """``(rank, counts)``: each row's stable rank within its bucket and the
    bucket histogram (int32); ids outside ``[0, num_buckets)`` get rank 0
    and are not counted."""
    _require(bucket_ids, torch.int32, "bucket_ids")
    dev = bucket_ids.device
    B = _size(num_buckets, "num_buckets")
    n = bucket_ids.shape[0]
    if n == 0 or B == 0:
        return (torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    tile = _size(tile, "tile")
    num_tiles = -(-n // tile)
    hist = torch.empty(num_tiles * B, dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("radix_rank", _lib().repro_radix_rank, bucket_ids.data_ptr(),
                n, B, tile, hist.data_ptr(), counts.data_ptr(),
                rank.data_ptr(), _stream(dev))
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
    cnt = torch.zeros(D, dtype=torch.int32, device=dev)
    inv = torch.zeros(D, dtype=torch.int32, device=dev)
    n = bk.shape[0]
    if n == 0 or D == 0:
        return cnt, inv
    with torch.cuda.device(dev):
        _launch("join_table_build", _lib().repro_join_table_build,
                bk.data_ptr(), brow.data_ptr(), n, cnt.data_ptr(),
                inv.data_ptr(), D, _stream(dev))
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
    with torch.cuda.device(dev):
        _launch("join_table_probe", _lib().repro_join_table_probe,
                pk.data_ptr(), n, cnt.data_ptr(), inv.data_ptr(), D,
                cnt_p.data_ptr(), inv_p.data_ptr(), _stream(dev))
    return cnt_p, inv_p
