"""Multi-key sort over torch tensors.

The contracts are those of ``src/repro/kernels/multikey_sort/ops.py``.  Each
op picks its implementation by the device of the tensors it is given: a
CUDA tensor launches the hand-written radix pass of :mod:`.kernel` (or
raises), a CPU tensor takes the plain version of :mod:`.ref`.

The TPU design sorts power-of-two tiles in VMEM and merges them; the Hopper
pass sorts the whole column, so ``tile`` has no effect here and is kept for
the contract (``multikey_sort_lsd`` still requires ``N`` to be a multiple
of it, as the reference does).  :func:`tile_sort` is built from the same
pass, sorting on (tile index, key, val), least significant first.

:func:`sort_perm` is the engine's entry
(``core/tensor_engine.sort_perm_device``): the stable lexicographic
permutation over key columns of any dtype ``torch.sort`` takes, with masked
rows sunk to the tail.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import kernel as _k
from . import ref as _ref

__all__ = ["sort_perm", "tile_sort", "multikey_sort_lsd",
           "multikey_sort_lsd_padded"]


def _one_pass(col: torch.Tensor, perm: Optional[torch.Tensor]):
    col = col.contiguous()
    if col.device.type == "cuda":
        return _k.radix_sort_pass(col, perm)
    return _ref.radix_sort_pass_ref(col, perm)


def sort_perm(key_cols: Sequence[torch.Tensor],
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int64 permutation ordering rows by ``key_cols`` (most significant
    first), stable in row order; rows where ``valid`` is False go last."""
    return _ref.lex_passes(tuple(key_cols), valid, _one_pass)


def _check_tile(n: int, tile: int) -> int:
    tile = min(tile, n)
    if n % tile or tile & (tile - 1):
        raise ValueError(f"N={n} must be a multiple of the power-of-two "
                         f"tile {tile}")
    return tile


def tile_sort(keys: torch.Tensor, vals: torch.Tensor, tile: int = 1024):
    """Sort each tile of ``(key, val)`` int32 pairs by ``(key, val)``
    ascending (stable when ``vals`` are positions); ``N % tile == 0``."""
    keys = keys.to(torch.int32)
    vals = vals.to(torch.int32)
    n = keys.shape[0]
    if n == 0:
        return keys, vals
    tile = _check_tile(n, tile)
    tile_ix = torch.arange(n, dtype=torch.int32, device=keys.device) // tile
    perm = sort_perm((tile_ix, keys, vals))
    return keys[perm], vals[perm]


def multikey_sort_lsd(key_cols: Sequence[torch.Tensor], tile: int = 1024):
    """Stable LSD multi-key sort of int32 key columns (most significant
    first); returns the int32 permutation.  Requires ``N % tile == 0``."""
    n = key_cols[0].shape[0]
    if n:
        _check_tile(n, tile)
    return multikey_sort_lsd_padded(key_cols, tile)


def multikey_sort_lsd_padded(key_cols: Sequence[torch.Tensor],
                             tile: int = 1024):
    """Arbitrary-N entry of :func:`multikey_sort_lsd`: keys are taken as
    int32, as the reference casts them; an empty input gives an empty
    permutation."""
    cols = tuple(c.to(torch.int32) for c in key_cols)
    return sort_perm(cols).to(torch.int32)
