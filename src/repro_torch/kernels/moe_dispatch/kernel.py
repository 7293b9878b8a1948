"""ctypes bindings for the Hopper kernels in ``csrc/moe_dispatch.cu``.

:func:`moe_dispatch` replaces
``src/repro/kernels/moe_dispatch/kernel.py::dispatch_pallas`` and
:func:`moe_combine` replaces ``::combine_pallas``.  Each wrapper checks the
device, dtype, shape and contiguity of its inputs and raises on anything
the kernel does not take, allocates the output (and the dispatch's int32
scratch) with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises if the launch reports a CUDA error, and adds one to its launch
counter.  They only take CUDA tensors; the plain versions in :mod:`.ref`
serve CPU tensors, chosen in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import count_launch, kernel_library

__all__ = ["moe_dispatch", "moe_combine"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = kernel_library("moe_dispatch")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_moe_dispatch_scratch_ints.argtypes = [ll, ll, ll]
        lib.repro_moe_dispatch_scratch_ints.restype = ll
        lib.repro_moe_dispatch.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
        lib.repro_moe_dispatch.restype = ctypes.c_int
        lib.repro_moe_combine.argtypes = [p, i, i, i, p, p, p, i, i, p, p]
        lib.repro_moe_combine.restype = ctypes.c_int
        lib.repro_moe_error_string.argtypes = [i]
        lib.repro_moe_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(t: torch.Tensor, what: str, dim: int, dtypes) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dim() != dim:
        raise ValueError(f"{what}: expected {dim} dimensions, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: expected one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_routing(eidx, slot, n: int, dev) -> None:
    for t, what in ((eidx, "eidx"), (slot, "slot")):
        _check(t, what, 1, (torch.int32,))
        if t.shape[0] != n or t.device != dev:
            raise ValueError(f"{what}: expected {n} entries on {dev}")


def _raise(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.repro_moe_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def moe_dispatch(x: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                 num_experts: int, capacity: int) -> torch.Tensor:
    """x ``[T, d]`` (float32 or bfloat16); eidx/slot ``[T]`` int32 → buf
    ``[E, C, d]`` in x's dtype: each (expert, slot) row is the float32 sum,
    in ascending t, of the x rows routed to it; assignments outside
    ``[0, E) x [0, C)`` are dropped."""
    _check(x, "x", 2, tuple(_DTYPES))
    T, d = x.shape
    _check_routing(eidx, slot, T, x.device)
    E, C = int(num_experts), int(capacity)
    if E < 1 or C < 1:
        raise ValueError(f"num_experts {E} and capacity {C} must be >= 1")
    if T > _INT_MAX or d > _INT_MAX or E * C > _INT_MAX:
        raise ValueError("sizes do not fit the kernel's int32 indices")
    buf = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    if d == 0:
        return buf
    lib = _lib()
    scratch = torch.empty(lib.repro_moe_dispatch_scratch_ints(T, E, C),
                          dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_moe_dispatch(
            x.data_ptr(), eidx.data_ptr(), slot.data_ptr(), T, d, E, C,
            _DTYPES[x.dtype], buf.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, rc, "moe_dispatch")
    count_launch("moe_dispatch")
    return buf


def moe_combine(buf: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]`` (float32 or bfloat16); eidx/slot ``[T]`` int32; w
    ``[T]`` float32 → y ``[T, d]`` in buf's dtype: ``w_t`` (cast to buf's
    dtype) times ``buf[eidx_t, slot_t]``, or zeros for a dropped
    assignment."""
    _check(buf, "buf", 3, tuple(_DTYPES))
    E, C, d = buf.shape
    T = eidx.shape[0] if isinstance(eidx, torch.Tensor) else -1
    _check_routing(eidx, slot, T, buf.device)
    _check(w, "w", 1, (torch.float32,))
    if w.shape[0] != T or w.device != buf.device:
        raise ValueError(f"w: expected {T} entries on {buf.device}")
    if T > _INT_MAX or d > _INT_MAX:
        raise ValueError("sizes do not fit the kernel's int32 indices")
    y = torch.empty((T, d), dtype=buf.dtype, device=buf.device)
    if T == 0 or d == 0 or E == 0 or C == 0:
        return y.zero_()
    lib = _lib()
    with torch.cuda.device(buf.device):
        rc = lib.repro_moe_combine(
            buf.data_ptr(), E, C, d, eidx.data_ptr(), slot.data_ptr(),
            w.data_ptr(), T, _DTYPES[buf.dtype], y.data_ptr(),
            torch.cuda.current_stream(buf.device).cuda_stream)
    _raise(lib, rc, "moe_combine")
    count_launch("moe_combine")
    return y
