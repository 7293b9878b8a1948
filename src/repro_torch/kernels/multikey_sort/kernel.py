"""ctypes binding for the Hopper kernel in ``csrc/multikey_sort.cu``.

:func:`radix_sort_pass` replaces
``src/repro/kernels/multikey_sort/kernel.py::bitonic_tile_sort_pallas``
(with the XLA merge of its tiles): one stable LSD radix pass over one key
column, through the current permutation.  The wrapper checks the device,
dtype, shape and contiguity of its inputs and raises on anything the kernel
does not take, allocates the output and the kernel's scratch with
``torch.empty``, launches on ``torch.cuda.current_stream()``, raises if the
launch reports a CUDA error, and adds one to its launch counter
(:func:`repro_torch.device.count_launch`).  It only takes CUDA tensors; the
plain version in :mod:`.ref` serves CPU tensors, chosen in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...device import (count_launch, device_guard, kernel_library,
                       stream_handle)
from .ref import key_kind

__all__ = ["radix_sort_pass", "digit_passes_run"]

_INT_MAX = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = kernel_library("multikey_sort")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_radix_sort_scratch_bytes.argtypes = [ll, i]
        lib.repro_radix_sort_scratch_bytes.restype = ll
        lib.repro_radix_sort_pass.argtypes = [p, i, i, ctypes.c_ulonglong, p,
                                              ll, p, p, p]
        lib.repro_radix_sort_pass.restype = ctypes.c_int
        lib.repro_radix_sort_ran_offset.argtypes = []
        lib.repro_radix_sort_ran_offset.restype = ll
        lib.repro_sort_error_string.argtypes = [i]
        lib.repro_sort_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _require_1d(t: torch.Tensor, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _sort_pass(col: torch.Tensor, perm: Optional[torch.Tensor]):
    """Launch the pass; returns ``(permutation, scratch)``."""
    _require_1d(col, "col")
    kind, inf_bits = key_kind(col.dtype)
    n = col.shape[0]
    if n > _INT_MAX:
        raise ValueError(f"{n} rows do not fit the kernel's int32 positions")
    dev = col.device
    if perm is not None:
        _require_1d(perm, "perm")
        if perm.dtype != torch.int64:
            raise TypeError(f"perm: expected torch.int64, got {perm.dtype}")
        if perm.shape != col.shape or perm.device != dev:
            raise ValueError("perm must be as long as col and on its device")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out, None
    lib = _lib()
    es = col.element_size()
    scratch = torch.empty(lib.repro_radix_sort_scratch_bytes(n, es),
                          dtype=torch.uint8, device=dev)
    with device_guard(dev):
        rc = lib.repro_radix_sort_pass(
            col.data_ptr(), es, kind, inf_bits,
            None if perm is None else perm.data_ptr(), n, out.data_ptr(),
            scratch.data_ptr(), stream_handle(dev))
    if rc != 0:
        msg = lib.repro_sort_error_string(rc).decode()
        raise RuntimeError(f"radix_sort_pass kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    count_launch("radix_sort_pass")
    return out, scratch


def radix_sort_pass(col: torch.Tensor,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of ``perm`` (the identity when None), stably sorted by the
    key ``col[perm]``: an int64 permutation of ``col``'s rows.  ``col`` may
    be bool, any integer or any float dtype; floats order as ``torch.sort``
    does (-0.0 equal to +0.0, NaN last).  Only the 8-bit digits in which
    the keys differ are sorted on; the kernel decides which on the device."""
    return _sort_pass(col, perm)[0]


def digit_passes_run(col: torch.Tensor,
                     perm: Optional[torch.Tensor] = None):
    """:func:`radix_sort_pass`, and the bit mask of the digit passes that
    ran (bit p: the digit of bits 8p..8p+7).  Reading the mask back waits
    for the device; tests and the smoke run hold it against
    :func:`..ref.digit_mask_ref`."""
    out, scratch = _sort_pass(col, perm)
    if scratch is None:
        return out, 0
    off = _lib().repro_radix_sort_ran_offset()
    word = scratch[off:off + 4].view(torch.int32)
    return out, int(word.item())
