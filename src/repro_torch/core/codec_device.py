"""Per-column device codecs: dictionary and frame-of-reference packing.

Device-resident columns (the table cache, the sharded partition
layouts) were stored at their logical width — int64 almost everywhere —
so both the cold host→device transfer and the warm HBM footprint paid
8 bytes/value regardless of the actual value domain.  This module picks
a *packed* physical layout per column:

  * ``dict``  — dictionary encoding: the column's sorted unique values
    are uploaded once (the dictionary) and the column itself is stored
    as narrow integer *codes* (ranks into the dictionary).  Eligible for
    low-cardinality integer columns (string surrogates, enum-like
    domains).
  * ``for``   — frame-of-reference: ``code = value - min(column)``
    stored at the narrowest signed width that fits the span.  Eligible
    for dense or clustered integer domains (timestamps, sequential ids).
  * ``raw``   — the logical representation, when neither codec wins
    (floats, already-narrow columns, wide sparse domains).

Both codecs are **order-preserving**: ``code_a < code_b`` iff
``value_a < value_b``.  That is what lets the tensor engine sort,
factorize and equi-join directly in the code domain and decode only the
values that survive to the single device→host fetch (the decode-at-fetch
rule; see docs/ARCHITECTURE.md "Compressed device layouts").

The widest code dtype's maximum value is *reserved*: packed code domains
exclude ``iinfo(code_dtype).max`` so the sorted-join cores can keep
using dtype-max as their padding sentinel, exactly as the int64 paths
reserve ``_I64_MAX``.

``REPRO_DEVICE_COMPRESS=0`` disables the codecs globally (every layout
degrades to ``raw``); the toggle is read at call time so tests and
benchmarks can flip it per cell.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DeviceColumnLayout",
    "DeviceCodes",
    "choose_layout",
    "compress_enabled",
    "decode_device",
    "decode_host",
    "dict_bucket",
    "encode_host",
    "pad_dictionary",
]

#: dictionaries above this cardinality never pay for themselves against
#: frame-of-reference at the same width (and would blow the int16 code
#: domain the probe kernels tile over)
DICT_MAX_CARD = 1 << 16

#: sample size for the cheap cardinality pre-check before committing to a
#: full ``np.unique`` over the column
_SAMPLE = 4096

_CODE_DTYPES = ("int8", "int16", "int32")

_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64,
}


def compress_enabled() -> bool:
    """Packed device layouts on?  Default yes; ``REPRO_DEVICE_COMPRESS=0``
    restores the logical-width uploads."""
    return os.environ.get("REPRO_DEVICE_COMPRESS", "1") != "0"


def _fit_dtype(span: int) -> Optional[str]:
    """Narrowest signed code dtype holding ``[0, span]`` with the dtype
    maximum left free for the join cores' padding sentinel."""
    for name in _CODE_DTYPES:
        if 0 <= span <= np.iinfo(name).max - 1:
            return name
    return None


@dataclass(frozen=True)
class DeviceColumnLayout:
    """Descriptor for one column's physical device representation.

    ``ref``/``card`` are data-dependent and deliberately excluded from
    :meth:`signature` — compiled programs close over the *shape* of the
    codec (encoding + dtypes) and take the reference point / dictionary
    as runtime inputs, so refreshing a table does not recompile.
    """

    encoding: str        # "raw" | "for" | "dict"
    code_dtype: str      # numpy dtype name of the stored codes
    logical_dtype: str   # numpy dtype name of the decoded values
    n: int               # rows described (diagnostics only)
    ref: int = 0         # frame-of-reference base (== column min)
    card: int = 0        # dictionary cardinality (dict only)

    @property
    def code_itemsize(self) -> int:
        return np.dtype(self.code_dtype).itemsize

    @property
    def logical_itemsize(self) -> int:
        return np.dtype(self.logical_dtype).itemsize

    def upload_bytes(self, rows: Optional[int] = None) -> int:
        """Physical H2D bytes to place ``rows`` values (default: all) on
        device under this layout — codes plus, for ``dict``, the
        bucket-padded dictionary itself."""
        rows = self.n if rows is None else rows
        total = rows * self.code_itemsize
        if self.encoding == "dict":
            total += dict_bucket(self.card) * self.logical_itemsize
        return total

    def signature(self) -> Tuple[str, str, str]:
        """Static part of the layout — safe to fold into compiled-program
        cache keys (never changes when the data is refreshed in place)."""
        return (self.encoding, self.code_dtype, self.logical_dtype)


def dict_bucket(card: int) -> int:
    """Power-of-two padding bucket for device dictionaries, so compiled
    programs keep their shapes across dictionary-size drift."""
    return max(16, 1 << max(0, int(card) - 1).bit_length())


def _raw_layout(col: np.ndarray) -> DeviceColumnLayout:
    name = col.dtype.name
    return DeviceColumnLayout("raw", name, name, len(col))


def choose_layout(col: np.ndarray
                  ) -> Tuple[DeviceColumnLayout, Optional[np.ndarray]]:
    """Pick the cheapest physical layout for ``col``.

    Returns ``(layout, dictionary)`` where ``dictionary`` is the sorted
    unique values for ``dict`` layouts and ``None`` otherwise.  Only
    integer columns wider than one byte are candidates; everything else
    (floats, bools, bytes) stays ``raw``.
    """
    if not compress_enabled():
        return _raw_layout(col), None
    if col.dtype.kind not in "iu" or len(col) == 0 or col.dtype.itemsize <= 1:
        return _raw_layout(col), None
    n = len(col)
    kmin, kmax = int(col.min()), int(col.max())
    fdt = _fit_dtype(kmax - kmin)
    best, aux = _raw_layout(col), None
    if fdt is not None and np.dtype(fdt).itemsize < col.dtype.itemsize:
        best = DeviceColumnLayout("for", fdt, col.dtype.name, n, ref=kmin)
    if best.code_itemsize > 1:
        # dictionary can still beat FOR when the domain is wide but sparse
        sample = col if n <= _SAMPLE else col[:: max(1, n // _SAMPLE)]
        if len(np.unique(sample)) <= max(2, len(sample) // 2):
            uniq = np.unique(col)
            card = len(uniq)
            ddt = _fit_dtype(card)  # codes live in [0, card); card = miss slot
            if card <= DICT_MAX_CARD and ddt is not None:
                cand = DeviceColumnLayout("dict", ddt, col.dtype.name, n,
                                          card=card)
                if cand.upload_bytes() < best.upload_bytes():
                    best, aux = cand, uniq
    return best, aux


def encode_host(col: np.ndarray, layout: DeviceColumnLayout,
                dictionary: Optional[np.ndarray] = None) -> np.ndarray:
    """Column values → packed codes (host side, before upload)."""
    if layout.encoding == "raw":
        return col
    if layout.encoding == "for":
        # col - ref stays within [0, span] so the subtraction cannot
        # overflow in the column's own dtype, signed or unsigned
        return (col - col.dtype.type(layout.ref)).astype(layout.code_dtype)
    return np.searchsorted(dictionary, col).astype(layout.code_dtype)


def decode_host(codes: np.ndarray, layout: DeviceColumnLayout,
                dictionary: Optional[np.ndarray] = None) -> np.ndarray:
    """Packed codes → logical values (host side; CRC-free inverse of
    :func:`encode_host`, used by tests and the numpy oracle checks)."""
    if layout.encoding == "raw":
        return codes
    ldt = np.dtype(layout.logical_dtype)
    if layout.encoding == "for":
        return codes.astype(ldt) + ldt.type(layout.ref)
    return dictionary[codes.astype(np.int64)]


def decode_device(codes, encoding: str, logical_dtype: str,
                  ref=None, dict_values=None):
    """Device-side decode: packed codes → logical values.

    ``encoding``/``logical_dtype`` describe the codec's shape; ``ref`` (a
    Python int) and ``dict_values`` (a device tensor) are runtime inputs.
    Codes outside the dictionary (garbage in padded or invalid rows) are
    clamped into it, so the gather never leaves the table.
    """
    if encoding == "raw":
        return codes
    ldt = _TORCH_DTYPES[np.dtype(logical_dtype).name]
    if encoding == "for":
        if ldt in (torch.uint16, torch.uint32, torch.uint64):
            # torch has no unsigned arithmetic past uint8: add in int64
            # (two's complement gives uint64's modular sum bit for bit)
            r = int(ref)
            wide = codes.to(torch.int64) + (r - (1 << 64) if r >= 1 << 63
                                            else r)
            return (wide.view(torch.uint64) if ldt == torch.uint64
                    else wide.to(ldt))
        return codes.to(ldt) + int(ref)
    idx = codes.to(torch.int64).clamp(0, dict_values.shape[0] - 1)
    return dict_values[idx]


def pad_dictionary(dictionary: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a sorted dictionary to ``bucket`` entries by repeating its last
    value.  ``searchsorted(..., side='left')`` still returns the *first*
    occurrence for a probe equal to the last value (a real code), and any
    probe greater than every dictionary entry still misses — so remapping
    against the padded dictionary is exact while the padded shape keeps
    compiled programs stable across dictionary-size drift."""
    if len(dictionary) >= bucket:
        return dictionary
    pad = np.full(bucket - len(dictionary), dictionary[-1],
                  dtype=dictionary.dtype)
    return np.concatenate([dictionary, pad])


@dataclass(frozen=True)
class DeviceCodes:
    """One device-resident packed column: codes + how to read them.

    ``codes`` may be bucket-padded (padding rows are zeros — never decoded
    thanks to the engines' row-count masks).  ``dict_values`` is the
    device-resident dictionary, padded to a power-of-two bucket via
    :func:`pad_dictionary` (``None`` unless ``layout.encoding == 'dict'``).
    """

    codes: Any
    layout: DeviceColumnLayout
    dict_values: Any = None

    @property
    def encoding(self) -> str:
        return self.layout.encoding

    def decode(self, arr=None):
        """Decode ``arr`` (default: the full code array) to logical
        values on device."""
        target = self.codes if arr is None else arr
        return decode_device(target, self.layout.encoding,
                             self.layout.logical_dtype,
                             ref=self.layout.ref,
                             dict_values=self.dict_values)
