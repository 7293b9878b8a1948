"""Plain PyTorch versions of the multi-key sort kernel.

:func:`radix_sort_pass_ref` repeats the arithmetic of the CUDA pass in
``csrc/multikey_sort.cu`` step by step: gather the key column through the
current permutation, map it to order-preserving unsigned bits
(:func:`order_bits`), then one stable pass per 8-bit digit, least
significant first (digit, histogram, exclusive scan, stable rank within
the digit, scatter).  The wrappers in :mod:`.ops` take it for CPU tensors;
the tests and ``chip_smoke.py`` hold the kernel against it on the card.

:func:`tile_sort_ref` has the contract of
``src/repro/kernels/multikey_sort/ref.py:9``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..segment_join.ref import radix_rank_ref

__all__ = ["key_kind", "order_bits", "radix_sort_pass_ref", "lex_passes",
           "sort_perm_ref", "tile_sort_ref", "UNSIGNED", "SIGNED", "FLOAT"]

#: key kinds of the kernel's interface
UNSIGNED, SIGNED, FLOAT = 0, 1, 2

_FLOAT_INF_BITS = {
    torch.float16: 0x7C00, torch.bfloat16: 0x7F80,
    torch.float32: 0x7F800000, torch.float64: 0x7FF0000000000000,
}
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)
_UNSIGNED = (torch.bool, torch.uint8, torch.uint16, torch.uint32,
             torch.uint64)
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_DIGIT_BITS = 8
_BUCKETS = 1 << _DIGIT_BITS


def key_kind(dtype: torch.dtype) -> Tuple[int, int]:
    """``(kind, inf_bits)`` of a key dtype: unsigned (bool included),
    signed or float with its +inf bit pattern.  Raises on other dtypes."""
    if dtype in _FLOAT_INF_BITS:
        return FLOAT, _FLOAT_INF_BITS[dtype]
    if dtype in _SIGNED:
        return SIGNED, 0
    if dtype in _UNSIGNED:
        return UNSIGNED, 0
    raise TypeError(f"no sort order for key dtype {dtype}")


def order_bits(col: torch.Tensor) -> torch.Tensor:
    """The key's order-preserving unsigned bits, held in int64 (a 64-bit
    key's pattern in two's complement): signed integers flip the sign bit;
    floats turn -0.0 into +0.0 and every NaN into one quiet NaN, then flip
    every bit when the sign is set, else only the sign bit."""
    kind, inf = key_kind(col.dtype)
    width = 8 * col.element_size()
    if col.dtype == torch.bool:
        raw = col.to(torch.int64)
    else:
        raw = col.view(_INT_VIEW[col.element_size()]).to(torch.int64)
    if width < 64:
        mask, sign = (1 << width) - 1, 1 << (width - 1)
        raw = raw & mask
    else:
        mask, sign = -1, -(1 << 63)
    if kind == SIGNED:
        return raw ^ sign
    if kind == FLOAT:
        mag = raw & (mask ^ sign)
        raw = torch.where(mag == 0, 0, raw)
        raw = torch.where(mag > inf, inf | (inf >> 1), raw)
        return torch.where((raw & sign) != 0, ~raw & mask, raw | sign)
    return raw


def radix_sort_pass_ref(col: torch.Tensor,
                        perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of ``perm`` (the identity when None), stably sorted by the
    key ``col[perm]``: an int64 permutation of ``col``'s rows."""
    n = col.shape[0]
    dev = col.device
    bits = order_bits(col)
    if perm is not None:
        bits = bits[perm]  # CUDA has no gather for uint16/32/64 columns
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    for p in range(col.element_size()):
        digit = ((bits >> (_DIGIT_BITS * p)) & (_BUCKETS - 1)).to(torch.int32)
        rank, counts = radix_rank_ref(digit, _BUCKETS)
        starts = torch.cumsum(counts, 0) - counts
        dest = starts[digit.long()] + rank
        moved_bits = torch.empty_like(bits)
        moved_pos = torch.empty_like(pos)
        moved_bits[dest] = bits
        moved_pos[dest] = pos
        bits, pos = moved_bits, moved_pos
    return pos if perm is None else perm[pos]


PassFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def lex_passes(key_cols: Sequence[torch.Tensor],
               valid: Optional[torch.Tensor], one_pass: PassFn
               ) -> torch.Tensor:
    """Stable lexicographic permutation over ``key_cols`` (most significant
    first) by LSD passes of ``one_pass``, least significant key first;
    with ``valid``, one last pass on ``~valid`` sinks masked rows to the
    tail without disturbing the order of live rows."""
    n = key_cols[0].shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=key_cols[0].device)
    perm = None
    for col in reversed(tuple(key_cols)):
        perm = one_pass(col, perm)
    if valid is not None:
        perm = one_pass(torch.logical_not(valid), perm)
    return perm


def sort_perm_ref(key_cols: Sequence[torch.Tensor],
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return lex_passes(key_cols, valid, radix_sort_pass_ref)


def tile_sort_ref(keys: torch.Tensor, vals: torch.Tensor, tile: int):
    """Sort (key, val) pairs within each tile by (key, val) ascending."""
    n = keys.shape[0]
    kt = keys.reshape(n // tile, tile)
    vt = vals.reshape(n // tile, tile)
    by_val = torch.argsort(vt, dim=-1, stable=True)
    by_key = torch.argsort(kt.gather(-1, by_val), dim=-1, stable=True)
    order = by_val.gather(-1, by_key)
    return kt.gather(-1, order).reshape(n), vt.gather(-1, order).reshape(n)
