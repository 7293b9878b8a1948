"""ctypes bindings for the Hopper kernels in ``csrc/moe_dispatch.cu``.

:func:`moe_dispatch` replaces
``src/repro/kernels/moe_dispatch/kernel.py::dispatch_pallas``, and
:func:`moe_combine` (one routing slot) and :func:`moe_combine_slots` (all k
slots of the layer, one launch) replace ``::combine_pallas``.
:func:`moe_combine_weight_grad` is the combine's routing-weight gradient
for training's backward (the reference differentiates its einsums).  Each wrapper
checks the device, dtype and shape of its inputs (and the contiguity of x
and buf) and raises on anything the kernel does not take, allocates the
output with ``torch.empty`` (the dispatch can add into a buffer it is
given instead), launches on ``torch.cuda.current_stream()``, raises if the
launch reports a CUDA error, and adds one to its launch counter.  Both
read the routing as it comes (int32 or int64 ids, float32 weights, any
stride); above the kernel's scan limit the dispatch needs an int32
workspace of (count, token) pairs, made zeroed once per device, stream and
host thread and left with zero counts by the kernel, so a call allocates
nothing else.  They only take CUDA tensors; the plain versions in
:mod:`.ref` serve CPU tensors, chosen in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from ...device import (count_launch, device_guard, kernel_library,
                       stream_handle)

__all__ = ["moe_dispatch", "moe_combine", "moe_combine_slots",
           "moe_combine_weight_grad"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX = {torch.int32: 0, torch.int64: 1}
_INT_MAX = 2**31 - 1
#: (device index, stream, host thread) -> the dispatch's int32 workspace:
#: calls that share one are ordered, since one thread issues them on one
#: stream
_WORKSPACE: Dict[Tuple[int, int, int], torch.Tensor] = {}
_WORKSPACE_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = kernel_library("moe_dispatch")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_moe_dispatch_workspace_ints.argtypes = [ll, ll, ll]
        lib.repro_moe_dispatch_workspace_ints.restype = ll
        lib.repro_moe_dispatch.argtypes = [p, i, i, p, ll, i, p, ll, i, i,
                                           i, i, p, p, p, p]
        lib.repro_moe_dispatch.restype = ctypes.c_int
        lib.repro_moe_combine.argtypes = [p, i, i, i, i, p, ll, ll, i, p,
                                          ll, ll, i, p, ll, ll, ll, i, p, p]
        lib.repro_moe_combine.restype = ctypes.c_int
        lib.repro_moe_combine_weight_grad.argtypes = [
            p, p, i, i, i, i, p, ll, ll, i, p, ll, ll, i, ll, i, p, p]
        lib.repro_moe_combine_weight_grad.restype = ctypes.c_int
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


def _raise(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.repro_moe_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _route_column(t, what: str, n: int, dev) -> None:
    if not isinstance(t, torch.Tensor) or t.device != dev:
        raise ValueError(f"{what}: expected a tensor on {dev}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what}: expected {n} entries, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _INDEX:
        raise TypeError(f"{what}: expected int32 or int64, got {t.dtype}")


def _workspace(dev: torch.device, stream: int,
               ints: int) -> Optional[torch.Tensor]:
    """The int32 workspace of at least ``ints`` entries for this device,
    stream and thread, made zeroed (the kernel leaves its counts zero);
    None when none is needed.  The caller holds the tensor until its launch
    is queued."""
    if ints == 0:
        return None
    key = (dev.index, stream, threading.get_ident())
    with _WORKSPACE_LOCK:
        ws = _WORKSPACE.get(key)
        if ws is None or ws.numel() < ints:
            ws = torch.zeros(ints, dtype=torch.int32, device=dev)
            _WORKSPACE[key] = ws
    return ws


def moe_dispatch(x: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                 num_experts: int, capacity: int,
                 into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``[T, d]`` (float32 or bfloat16); eidx/slot ``[T]`` int32 or int64
    at any stride (a column of the ``[T, k]`` routing) → buf ``[E, C, d]``
    in x's dtype: each (expert, slot) row is the float32 sum, in ascending
    t, of the x rows routed to it; assignments outside ``[0, E) x [0, C)``
    are dropped.  With ``into`` (``[E, C, d]``, x's dtype, contiguous) the
    dispatch is added into it in place, rounded as ``into + buf`` rounds,
    and ``into`` is returned."""
    _check(x, "x", 2, tuple(_DTYPES))
    T, d = x.shape
    dev = x.device
    _route_column(eidx, "eidx", T, dev)
    _route_column(slot, "slot", T, dev)
    E, C = int(num_experts), int(capacity)
    if E < 1 or C < 1:
        raise ValueError(f"num_experts {E} and capacity {C} must be >= 1")
    if T > _INT_MAX or d > _INT_MAX or E * C > _INT_MAX:
        raise ValueError("sizes do not fit the kernel's int32 indices")
    if into is None:
        buf = torch.empty((E, C, d), dtype=x.dtype, device=dev)
    else:
        _check(into, "into", 3, (x.dtype,))
        if tuple(into.shape) != (E, C, d) or into.device != dev:
            raise ValueError(f"into: expected ({E}, {C}, {d}) on {dev}, got "
                             f"{tuple(into.shape)} on {into.device}")
        buf = into
    if d == 0:
        return buf
    lib = _lib()
    stream = stream_handle(dev)
    with device_guard(dev):
        ws = _workspace(dev, stream,
                        lib.repro_moe_dispatch_workspace_ints(T, E, C))
        rc = lib.repro_moe_dispatch(
            x.data_ptr(), T, d, eidx.data_ptr(), eidx.stride(0),
            _INDEX[eidx.dtype], slot.data_ptr(), slot.stride(0),
            _INDEX[slot.dtype], E, C, _DTYPES[x.dtype],
            None if into is None else into.data_ptr(), buf.data_ptr(),
            None if ws is None else ws.data_ptr(), stream)
    _raise(lib, rc, "moe_dispatch")
    count_launch("moe_dispatch")
    return buf


def moe_combine(buf: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]`` (float32 or bfloat16); eidx/slot ``[T]`` int32 or
    int64 and w ``[T]`` float32, at any stride → y ``[T, d]`` in buf's
    dtype: ``w_t`` (cast to buf's dtype) times ``buf[eidx_t, slot_t]``, or
    +0.0 for a dropped assignment.  The k = 1 case of
    :func:`moe_combine_slots`."""
    return moe_combine_slots(buf, eidx[:, None], slot[:, None], w[:, None])


def moe_combine_slots(buf: torch.Tensor, topk_idx: torch.Tensor,
                      slot: torch.Tensor,
                      topk_w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]`` (float32 or bfloat16); topk_idx/slot ``[T, k]``
    int32 or int64 and topk_w ``[T, k]`` float32, at any strides (k >= 1) →
    y ``[T, d]`` in buf's dtype: the k slots' combines ``w_tj ·
    buf[e_tj, s_tj]`` (each rounded to buf's dtype, +0.0 when dropped)
    added in j order, each partial sum rounded to buf's dtype, as ``y = c
    if y is None else y + c`` rounds them.  One launch."""
    _check(buf, "buf", 3, tuple(_DTYPES))
    E, C, d = buf.shape
    dev = buf.device
    if not isinstance(topk_idx, torch.Tensor) or topk_idx.dim() != 2:
        raise ValueError("topk_idx: expected a [T, k] tensor")
    T, k = topk_idx.shape
    for t, what in ((topk_idx, "topk_idx"), (slot, "slot"),
                    (topk_w, "topk_w")):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{what}: expected a tensor on {dev}")
        if tuple(t.shape) != (T, k):
            raise ValueError(f"{what}: expected ({T}, {k}), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in ((torch.float32,) if t is topk_w else _INDEX):
            raise TypeError(f"{what}: unexpected dtype {t.dtype}")
    if k < 1:
        raise ValueError("expected at least one routing slot")
    if d > _INT_MAX or E * C > _INT_MAX:
        raise ValueError("sizes do not fit the kernel's int32 indices")
    y = torch.empty((T, d), dtype=buf.dtype, device=dev)
    if T == 0 or d == 0:
        return y
    lib = _lib()
    with device_guard(dev):
        rc = lib.repro_moe_combine(
            buf.data_ptr(), E, C, d, k, topk_idx.data_ptr(),
            *topk_idx.stride(), _INDEX[topk_idx.dtype], slot.data_ptr(),
            *slot.stride(), _INDEX[slot.dtype], topk_w.data_ptr(),
            *topk_w.stride(), T, _DTYPES[buf.dtype], y.data_ptr(),
            stream_handle(dev))
    _raise(lib, rc, "moe_combine")
    count_launch("moe_combine")
    return y


def moe_combine_weight_grad(dy: torch.Tensor, buf: torch.Tensor,
                            topk_idx: torch.Tensor,
                            slot: torch.Tensor) -> torch.Tensor:
    """dy ``[T, d]`` and buf ``[E, C, d]`` (contiguous, one dtype, float32
    or bfloat16); topk_idx/slot ``[T, k]`` int32 or int64 at any strides →
    dw ``[T, k]`` float32: ``dw[t, j] = Σ_d dy[t, d] · buf[e_tj, s_tj,
    d]`` summed in float32, +0.0 for a dropped assignment.  One launch."""
    _check(buf, "buf", 3, tuple(_DTYPES))
    _check(dy, "dy", 2, (buf.dtype,))
    E, C, d = buf.shape
    dev = buf.device
    if not isinstance(topk_idx, torch.Tensor) or topk_idx.dim() != 2:
        raise ValueError("topk_idx: expected a [T, k] tensor")
    T, k = topk_idx.shape
    if tuple(dy.shape) != (T, d) or dy.device != dev:
        raise ValueError(f"dy: expected ({T}, {d}) on {dev}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    for t, what in ((topk_idx, "topk_idx"), (slot, "slot")):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{what}: expected a tensor on {dev}")
        if tuple(t.shape) != (T, k):
            raise ValueError(f"{what}: expected ({T}, {k}), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _INDEX:
            raise TypeError(f"{what}: expected int32 or int64, got {t.dtype}")
    if k < 1:
        raise ValueError("expected at least one routing slot")
    if d > _INT_MAX or E * C > _INT_MAX:
        raise ValueError("sizes do not fit the kernel's int32 indices")
    dw = torch.empty((T, k), dtype=torch.float32, device=dev)
    if T == 0:
        return dw
    if d == 0:
        return dw.zero_()
    lib = _lib()
    with device_guard(dev):
        rc = lib.repro_moe_combine_weight_grad(
            dy.data_ptr(), buf.data_ptr(), E, C, d, k, topk_idx.data_ptr(),
            *topk_idx.stride(), _INDEX[topk_idx.dtype], slot.data_ptr(),
            *slot.stride(), _INDEX[slot.dtype], T, _DTYPES[buf.dtype],
            dw.data_ptr(), stream_handle(dev))
    _raise(lib, rc, "moe_combine_weight_grad")
    count_launch("moe_combine_weight_grad")
    return dw
