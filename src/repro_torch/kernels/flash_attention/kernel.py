"""ctypes bindings for the Hopper flash-attention kernels, and the choice
between them.

:func:`flash_attention_fwd` replaces
``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas`` with
the epilogue of its ``ops.py`` (the division by ``max(l, 1e-30)`` and the
cast to q's dtype).  It takes the model layout ``[B, S, H, D]`` through
strides, so no transpose is made.  Two kernels serve it, chosen by dtype in
:func:`select_kernel`:

* bfloat16 (the prefill's dtype): ``csrc/flash_attention_sm90.cu``, both
  products on the tensor cores (``wgmma``), K/V fed by TMA; D and Dv
  multiples of 16 up to 256, pointers and strides 16-byte aligned (TMA's
  rule).  Launch counter ``flash_attention``.
* float32: ``csrc/flash_attention.cu``, both products on the tensor cores
  (``mma.sync`` TF32) in the 3xTF32 split, which holds the reference's
  float32 tolerance; D and Dv up to 256, any element strides.  Launch
  counter ``flash_attention_f32``.

With ``return_lse=True`` (the training path) the kernel also writes each
row's logsumexp ``[B, H, Sq]`` float32 (the natural log of the scaled,
capped scores; +inf for a row with no visible key): the float32 kernel
through its ``repro_flash_attention_lse`` entry (counter
``flash_attention_f32`` still), the bf16 one through the instantiation
with the logsumexp epilogue, ``repro_flash_attention_sm90_lse`` (counter
``flash_attention_lse``; the serving instantiation is untouched).
:func:`flash_attention_bwd` reads it, with the backward kernel of q's
dtype, both with dK/dV per key tile summed over the GQA group and dQ per
query tile, no atomics, so the same bits on every run, one launch count a
call for their three kernels:

* float32: ``csrc/flash_attention_bwd.cu`` (``mma.sync`` TF32 in the
  3xTF32 split; counter ``flash_attention_bwd_f32``), float32 gradients;
* bfloat16: ``csrc/flash_attention_bwd_bf16.cu`` (``wgmma`` bf16 with
  float32 accumulators, fed by TMA; counter ``flash_attention_bwd_bf16``),
  bf16 gradients; every pointer and stride 16-byte aligned, as the bf16
  forward needs.

The gradients come back contiguous in q's, k's and v's layouts.

What neither kernel takes raises ``ValueError``; nothing falls back to the
other kernel or to the plain version.  The wrapper allocates the output with
``torch.empty``, launches on ``torch.cuda.current_stream()``, raises if the
launch reports an error, and adds one to the chosen kernel's counter.  It
only takes CUDA tensors; the plain version in :mod:`.ref` serves CPU
tensors, chosen in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...device import (count_launch, device_guard, kernel_library,
                       stream_handle)

__all__ = ["flash_attention_fwd", "flash_attention_bwd", "select_kernel",
           "tma_strides", "aligned16", "nokey_from", "MAX_HEAD_DIM",
           "TENSOR_CORE_KERNEL", "F32_KERNEL", "LSE_KERNEL", "BWD_KERNEL",
           "BWD_BF16_KERNEL"]

MAX_HEAD_DIM = 256
#: launch-counter names of the kernels: the two forwards, the bf16
#: forward's instantiation that writes the logsumexp, the two backwards
TENSOR_CORE_KERNEL = "flash_attention"
F32_KERNEL = "flash_attention_f32"
LSE_KERNEL = "flash_attention_lse"
BWD_KERNEL = "flash_attention_bwd_f32"
BWD_BF16_KERNEL = "flash_attention_bwd_bf16"
_DTYPES = (torch.float32, torch.bfloat16)
_I32 = 2 ** 31


#: launch-counter name -> (source stem, C entry point, its error strings)
_ENTRIES = {
    TENSOR_CORE_KERNEL: ("flash_attention_sm90", "repro_flash_attention_sm90",
                         "repro_flash_sm90_error_string"),
    F32_KERNEL: ("flash_attention", "repro_flash_attention",
                 "repro_flash_error_string"),
}


def _entry(name: str):
    """The bound C entry point and error-string function of kernel
    ``name``; both take the same arguments."""
    stem, fn_name, err_name = _ENTRIES[name]
    lib = kernel_library(stem)
    fn, errors = getattr(lib, fn_name), getattr(lib, err_name)
    if fn.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 12 + [i, i, f, f, ll, p]
        fn.restype = i
        errors.argtypes = [i]
        errors.restype = ctypes.c_char_p
    return fn, errors


def _lse_entry(name: str):
    """The entry of kernel ``name`` (float32 or bf16) that also writes the
    logsumexp: its arguments with the ``lse`` pointer before the stream."""
    stem, fn_name, _ = _ENTRIES[name]
    fn = getattr(kernel_library(stem), fn_name + "_lse")
    if fn.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 12 + [i, i, f, f, ll, p, p]
        fn.restype = i
    return fn, _entry(name)[1]


#: backward launch-counter name -> (source stem, C entry, error strings)
_BWD_ENTRIES = {
    BWD_KERNEL: ("flash_attention_bwd", "repro_flash_attention_bwd",
                 "repro_flash_bwd_error_string"),
    BWD_BF16_KERNEL: ("flash_attention_bwd_bf16",
                      "repro_flash_attention_bwd_bf16",
                      "repro_flash_bwd_bf16_error_string"),
}


def _bwd_entry(name: str):
    stem, fn_name, err_name = _BWD_ENTRIES[name]
    lib = kernel_library(stem)
    fn, errors = getattr(lib, fn_name), getattr(lib, err_name)
    if fn.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = ([p] * 10 + [i] * 7 + [ll] * 15 +
                       [i, i, f, f, ll, ll, p])
        fn.restype = i
        errors.argtypes = [i]
        errors.restype = ctypes.c_char_p
    return fn, errors


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, row, head) element strides of a ``[B, S, heads, dim]``
    tensor as the kernels take them: a dimension of size 1 gets the packed
    stride of the dimension inside it, since PyTorch leaves such a stride
    arbitrary and a TMA descriptor checks every stride's alignment."""
    B, S, Hd, Dd = t.shape
    sb, ss, sh = t.stride()[:3]
    sh = sh if Hd > 1 else Dd
    ss = ss if S > 1 else Hd * sh
    sb = sb if B > 1 else S * ss
    return sb, ss, sh


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s base address and the strides of its leading
    dimensions (:func:`tma_strides`) are whole 16 bytes: the bf16 kernels'
    rule (TMA in the forward, 16-byte copies in the backward)."""
    return t.data_ptr() % 16 == 0 and not any(
        s * t.element_size() % 16 for s in tma_strides(t))


def _check_layout(t, what: str, dtype=None) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 4:
        raise ValueError(f"{what}: expected a [B, S, heads, dim] tensor, got "
                         f"{getattr(t, 'shape', type(t))}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: no kernel takes {t.dtype} (float32 or "
                         f"bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype} differs from q's {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the last dimension must be contiguous")


def select_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The launch-counter name of the kernel that serves these inputs:
    :data:`TENSOR_CORE_KERNEL` for bfloat16, :data:`F32_KERNEL` for
    float32.  Pure: reads dtypes, shapes, strides and data pointers only,
    so it runs on CPU tensors too.  Raises ``ValueError`` on what no kernel
    takes."""
    _check_layout(q, "q")
    _check_layout(k, "k", q.dtype)
    _check_layout(v, "v", q.dtype)
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
    if max(B, Sq, Sk, H) >= _I32:
        raise ValueError("a dimension does not fit the kernel's int32")
    if H >= 65536 or B >= 65536:
        raise ValueError(f"grid of {H} heads x {B} batches is too large")
    if q.dtype == torch.float32:
        return F32_KERNEL
    if D % 16 or Dv % 16 or D < 16 or Dv < 16:
        raise ValueError(f"the bfloat16 kernel takes head dims that are "
                         f"multiples of 16, got D {D}, Dv {Dv}")
    if Sk < 1:
        raise ValueError("the bfloat16 kernel needs at least one key")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: TMA needs a 16-byte-aligned base, got "
                             f"address {t.data_ptr():#x}")
        if any(s * t.element_size() % 16 for s in tma_strides(t)):
            raise ValueError(f"{what}: TMA needs strides of whole 16 bytes, "
                             f"got {t.stride()} in {t.dtype}")
    return TENSOR_CORE_KERNEL


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, scale: float,
                        q_offset: int = 0, return_lse: bool = False):
    """q ``[B, Sq, H, D]``; k ``[B, Sk, KH, D]``; v ``[B, Sk, KH, Dv]``
    (one dtype, float32 or bfloat16) → ``[B, Sq, H, Dv]`` in q's dtype.
    Query row i sits at position ``q_offset + i``; kv head ``h // (H //
    KH)`` serves query head h.  With ``return_lse`` → ``(out, lse)``, lse
    ``[B, H, Sq]`` float32."""
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    name = select_kernel(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    opts = (int(bool(causal)), int(window or 0), float(cap or 0.0),
            float(scale), int(q_offset))
    if return_lse:
        fn, errors = _lse_entry(name)
        tail = (lse.data_ptr(), stream_handle(q.device))
        if name == TENSOR_CORE_KERNEL:
            name = LSE_KERNEL
    else:
        fn, errors = _entry(name)
        tail = (stream_handle(q.device),)
    with device_guard(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KH, D, Dv, *tma_strides(q), *tma_strides(k),
                *tma_strides(v), *out.stride()[:3], *opts, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc} "
                           f"({errors(rc).decode()})")
    count_launch(name)
    return (out, lse) if return_lse else out


def nokey_from(Sq: int, Sk: int, *, causal: bool, window: Optional[int],
               q_offset: int) -> int:
    """The first query row that sees no key (``Sq`` when every row sees
    one): visible keys are ``[pos - window + 1, pos]`` (causal) or ``(pos -
    window, Sk)``, so with a window the rows at ``q_offset + i >= Sk +
    window - 1`` see none; without one, every row sees key 0 or all."""
    if window is None:
        return Sq
    return max(0, min(Sq, Sk + window - 1 - q_offset))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        cap: Optional[float] = None, scale: float,
                        q_offset: int = 0):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd`'s
    output for ``dout`` ``[B, Sq, H, Dv]``, given the forward's ``out``
    and ``lse`` (float32); in q's dtype (the float32 or the bf16 backward
    kernel), contiguous, in q's, k's and v's shapes.  Inputs at any strides
    with a contiguous last dimension; bf16 ones 16-byte aligned
    (:func:`aligned16`)."""
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (lse, "lse"), (dout, "dout")):
        if not isinstance(t, torch.Tensor) or t.device != q.device or \
                t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor on q's device")
        want = torch.float32 if what == "lse" else q.dtype
        if t.dtype != want:
            raise ValueError(f"{what}: the backward kernel takes {want}, "
                             f"got {t.dtype}")
    name = (BWD_KERNEL if select_kernel(q, k, v) == F32_KERNEL
            else BWD_BF16_KERNEL)
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    for t, what in ((out, "out"), (dout, "dout")):
        if tuple(t.shape) != (B, Sq, H, Dv) or t.stride(-1) != 1:
            raise ValueError(f"{what}: expected ({B}, {Sq}, {H}, {Dv}) with "
                             f"a contiguous last dimension")
        if name == BWD_BF16_KERNEL and not aligned16(t):
            raise ValueError(f"{what}: the bf16 backward needs a 16-byte-"
                             f"aligned base and strides, got {t.stride()}")
    if tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous():
        raise ValueError(f"lse: expected contiguous ({B}, {H}, {Sq})")
    if Sk < 1:
        raise ValueError("the backward kernel needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    dev = q.device
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Sk, KH, Dv), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    nk = nokey_from(Sq, Sk, causal=causal, window=window, q_offset=q_offset)
    fn, errors = _bwd_entry(name)
    with device_guard(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, H, KH, D, Dv, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
                int(bool(causal)), int(window or 0), float(cap or 0.0),
                float(scale), int(q_offset), nk, stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc} "
                           f"({errors(rc).decode()})")
    count_launch(name)
    return dq, dk, dv
