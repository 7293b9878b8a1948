"""Device selection, the CUDA kernel build, and per-kernel launch counters.

Every entry point of :mod:`repro_torch` runs on the CUDA card unless the
caller asks for the CPU (``device="cpu"``), as the CPU tests do.  Asking for
CUDA on a machine without a card raises: the engine never quietly carries
on on the CPU.

The hand-written kernels live in ``src/repro_torch/csrc/*.cu`` with a plain
C interface.  :func:`kernel_library` compiles them at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/repro_torch_kernels/<hash>/`` at the repository root (the hash
covers the sources, the headers they share and the flags, so an edited
source or header rebuilds) and loads
the shared library with ``ctypes``.  Nothing here runs at import time.

:data:`LAUNCHES` holds one plain integer per kernel.  Each kernel wrapper
adds one (:func:`count_launch`) where it launches its kernel, and nowhere
else, so a run can show which kernels its main path went through
(``reset_launch_counts`` before, ``launch_counts`` after).  The three take
one lock: serving threads launch kernels concurrently, and ctypes releases
the interpreter lock during a launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

__all__ = ["resolve_device", "synchronize", "to_host", "upload", "LAUNCHES",
           "RELATIONAL_KERNELS", "count_launch", "launch_counts",
           "reset_launch_counts", "kernel_library", "build_seconds",
           "NVCC_FLAGS", "device_guard", "stream_handle"]

DeviceLike = Union[str, torch.device, None]

_PKG_DIR = Path(__file__).resolve().parent
_CSRC = _PKG_DIR / "csrc"
_REPO_ROOT = _PKG_DIR.parents[1]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {
    "segment_sum": 0,
    "radix_rank": 0,
    "join_table_build": 0,
    "join_table_probe": 0,
    "radix_sort_pass": 0,
    "flash_attention": 0,        # bfloat16, tensor cores (wgmma)
    "flash_attention_f32": 0,    # float32, tensor cores in 3xTF32
    "flash_attention_bwd_f32": 0,  # its backward, float32 (3xTF32)
    "flash_attention_lse": 0,    # bfloat16 writing its logsumexp
    "flash_attention_bwd_bf16": 0,  # its backward, bfloat16 (wgmma)
    "moe_dispatch": 0,
    "moe_combine": 0,
    "moe_combine_weight_grad": 0,  # the combine's routing-weight gradient
}
#: the relational engine's kernels; the LM path's are the others
RELATIONAL_KERNELS = ("segment_sum", "radix_rank", "join_table_build",
                      "join_table_probe", "radix_sort_pass")
_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name``; only its wrapper calls this."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """A snapshot of the per-kernel launch counters."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The engine's device: CUDA unless the caller names another.  A tuple
    of devices (where a sharded fragment's partitions go,
    :func:`repro_torch.distributed.sharding.placement_devices`) names the
    engine's device first.

    Raises when CUDA is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is false."""
    if isinstance(device, (tuple, list)):
        if not device:
            raise ValueError("an empty tuple names no device")
        device = device[0]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run the engine on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_guard(dev: torch.device):
    """A context in which ``dev`` (a CUDA tensor's device) is the current
    device, for a launch through ctypes; none is entered when it already
    is (a kernel called once a decode step pays ``torch.cuda.device``'s
    microseconds every call otherwise)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(dev: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``dev`` (a
    CUDA tensor's device).  Through torch's private
    ``_cuda_getCurrentRawStream`` (present in torch 2.11), which makes no
    ``torch.cuda.Stream`` object: that costs more host time than a small
    kernel's launch.  A torch without it takes the public call."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# Kernel build (nvcc -> shared library -> ctypes)
# ---------------------------------------------------------------------------

_LIB_LOCK = threading.Lock()
_BUILD_SECONDS = 0.0


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if root:
        return Path(root)
    return _REPO_ROOT / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _compile_one(nvcc: str, src: Path, out: Path):
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp


def _build() -> Dict[str, Path]:
    """Compile every source that is not built yet (one nvcc per source, all
    started together); returns ``{source stem: shared library path}``."""
    global _BUILD_SECONDS
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(srcs + list(_CSRC.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _build_dir() / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in srcs}
    todo = [(src, libs[src.stem]) for src in srcs
            if not libs[src.stem].exists()]
    if todo:
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [(src, out, *_compile_one(nvcc, src, out))
                 for src, out in todo]
        errors = []
        for src, out, proc, tmp in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
                continue
            os.replace(tmp, out)
        _BUILD_SECONDS = time.perf_counter() - t0
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``.  The first
    call builds every source; only a wrapper about to launch on a CUDA
    tensor (or a script that wants the build done up front) calls this."""
    with _LIB_LOCK:
        if not _LIBS:
            for stem, path in _build().items():
                _LIBS[stem] = ctypes.CDLL(str(path))
        return _LIBS[name]


def build_seconds() -> float:
    """Seconds this process spent in nvcc (0 when every library was
    already built)."""
    return _BUILD_SECONDS


# ---------------------------------------------------------------------------
# Device -> host transfer
# ---------------------------------------------------------------------------

_NP_DTYPES = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
    torch.float16: "float16", torch.float32: "float32",
    torch.float64: "float64",
}


def to_host(tensors) -> list:
    """Bring a list of tensors to the host as numpy arrays with ONE batched
    device→host copy and ONE synchronise.

    On a CUDA device the tensors are packed into one byte buffer on the
    device (each piece padded to 8 bytes), copied once into pinned host
    memory, and the stream is synchronised once; the returned arrays are
    views into that buffer.  On the CPU the arrays share the tensors'
    memory.  numpy has no bfloat16: a bfloat16 tensor is cast to float32
    on its device first (exactly), and comes back as float32."""
    from .core.metrics import span

    with span("fetch") as s:
        arrays = _to_host(tensors)
        if s:
            s.set("bytes", sum(a.nbytes for a in arrays))
    return arrays


def _to_host(tensors) -> list:
    tensors = [t.detach() for t in tensors]
    tensors = [t.float() if t.dtype == torch.bfloat16 else t
               for t in tensors]
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    pieces, metas = [], []
    offset = 0
    for t in tensors:
        flat = t.contiguous().reshape(-1)
        nbytes = flat.numel() * flat.element_size()
        pieces.append(flat.view(torch.uint8))
        pad = (-nbytes) % 8
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
        metas.append((offset, nbytes, _NP_DTYPES[t.dtype], tuple(t.shape)))
        offset += nbytes + pad
    packed = torch.cat(pieces)
    from .core.metrics import span

    with span("pin") as s:
        host = torch.empty(packed.numel(), dtype=torch.uint8,
                           pin_memory=True)
        s.set("bytes", packed.numel())
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    buf = host.numpy()
    return [buf[off:off + nb].view(np.dtype(dt)).reshape(shape)
            for off, nb, dt, shape in metas]


def upload(arr, device: torch.device) -> torch.Tensor:
    """Host→device transfer of one numpy array (dtype preserved).  On the
    CPU the result is a copy, so the engine's "device" columns never alias
    the caller's arrays."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.clone() if device.type == "cpu" else t.to(device)
