"""ctypes binding for the Hopper kernel in ``csrc/flash_attention.cu``.

:func:`flash_attention_fwd` replaces
``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas`` with
the epilogue of its ``ops.py`` (the division by ``max(l, 1e-30)`` and the
cast to q's dtype).  It takes the model layout ``[B, S, H, D]`` through
strides, so no transpose is made.  The wrapper checks the device, dtype,
shape and strides of its inputs and raises on anything the kernel does not
take, allocates the output with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reports a CUDA error,
and adds one to its launch counter.  It only takes CUDA tensors; the plain
version in :mod:`.ref` serves CPU tensors, chosen in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...device import count_launch, kernel_library

__all__ = ["flash_attention_fwd", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = kernel_library("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.repro_flash_attention.argtypes = (
            [p, p, p, p] + [i] * 8 + [ll] * 12 + [i, i, f, f, ll, p])
        lib.repro_flash_attention.restype = ctypes.c_int
        lib.repro_flash_error_string.argtypes = [i]
        lib.repro_flash_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(t: torch.Tensor, what: str, dtype=None) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected [B, S, heads, dim], got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what}: expected float32 or bfloat16, got "
                        f"{t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype} differs from q's {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the last dimension must be contiguous")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, scale: float,
                        q_offset: int = 0) -> torch.Tensor:
    """q ``[B, Sq, H, D]``; k ``[B, Sk, KH, D]``; v ``[B, Sk, KH, Dv]``
    (one dtype, float32 or bfloat16) → ``[B, Sq, H, Dv]`` in q's dtype.
    Query row i sits at position ``q_offset + i``; kv head ``h // (H //
    KH)`` serves query head h."""
    _check(q, "q")
    _check(k, "k", q.dtype)
    _check(v, "v", q.dtype)
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or v.shape[0] != B or tuple(v.shape[1:3]) != (Sk, KH):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if k.shape[3] != D:
        raise ValueError(f"k's head dim {k.shape[3]} differs from q's {D}")
    if KH < 1 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims {D}/{Dv} exceed {MAX_HEAD_DIM}")
    if max(B, Sq, Sk, H) >= 2**31:
        raise ValueError("a dimension does not fit the kernel's int32")
    if H >= 65536 or B >= 65536:
        raise ValueError(f"grid of {H} heads x {B} batches is too large")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(bool(causal)), int(window or 0),
            float(cap or 0.0), float(scale), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.repro_flash_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    count_launch("flash_attention")
    return out
