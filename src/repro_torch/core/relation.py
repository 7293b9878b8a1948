"""Columnar relation abstraction.

A :class:`Relation` is a named set of equal-length 1-D columns (numpy arrays on
the host side; the tensor engine uploads them to the device lazily).  Columns are
kept *separate* — this is the "multi-attribute structure" the paper argues the
execution layer should preserve: each attribute is its own axis/column until an
operator genuinely needs a linearized form.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np

__all__ = ["Relation", "column_token"]


def column_token(arr: np.ndarray) -> tuple:
    """Cheap content fingerprint of a column: O(32) sampled elements.

    Combines the buffer address, length, dtype, and a CRC over a strided
    sample (always including the first and last element).  Device caches key
    on this token, so an in-place mutation of a cached column is detected —
    with sampled (not cryptographic) confidence — and forces a fresh
    transfer.  Callers that mutate columns between queries should also call
    :meth:`Relation.invalidate_device_cache` for a guaranteed refresh.
    """
    n = len(arr)
    dt = str(arr.dtype)
    if n == 0:
        return (0, 0, dt, 0)
    stride = max(1, n // 32)
    sample = np.concatenate([arr[::stride], arr[-1:]])
    crc = zlib.crc32(np.ascontiguousarray(sample).tobytes())
    try:
        ptr = arr.__array_interface__["data"][0]
    except (AttributeError, KeyError):
        ptr = id(arr)
    return (ptr, n, dt, crc)


@dataclasses.dataclass
class Relation:
    """An immutable columnar relation."""

    columns: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        if not self.columns:
            raise ValueError("Relation needs at least one column")
        lengths = {k: len(v) for k, v in self.columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        # normalize to contiguous numpy arrays
        self.columns = {k: np.ascontiguousarray(v) for k, v in self.columns.items()}

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_dict(cols: Mapping[str, Sequence]) -> "Relation":
        return Relation({k: np.asarray(v) for k, v in cols.items()})

    # -- basic properties ----------------------------------------------------
    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    @property
    def names(self) -> tuple:
        return tuple(self.columns.keys())

    def __len__(self) -> int:
        return self.num_rows

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def nbytes(self) -> int:
        return int(sum(c.nbytes for c in self.columns.values()))

    def fingerprint(self) -> tuple:
        """Aggregate of the per-column tokens (see :func:`column_token`).

        The device base-table cache and key-cardinality sketch key on the
        individual column tokens (so mutating one column only invalidates
        that column); this whole-relation aggregate is the convenience form
        for callers that want to snapshot/compare table versions.
        """
        return tuple((name, column_token(col))
                     for name, col in self.columns.items())

    def invalidate_device_cache(self) -> None:
        """Drop cached device uploads and key sketches for this relation.

        The caches invalidate automatically via sampled content tokens; this
        is the explicit, guaranteed path for callers that mutate columns
        in place between queries.  The cache dicts are cleared *in place*
        and kept (not popped): sub-relations made with :meth:`select` share
        them by reference, so clearing invalidates every selection while
        preserving the shared-object contract for later warm-sharing.
        """
        for attr in ("_device_cache", "_key_stats", "_packed_cols",
                     "_sel_cache", "_partition_cache", "_layout_cache"):
            store = self.__dict__.get(attr)
            if store is not None:
                store.clear()
        self.__dict__.pop("_device_cols", None)  # pre-PR2 attr name

    def row_bytes(self) -> int:
        return int(sum(c.dtype.itemsize for c in self.columns.values()))

    # -- row-wise ops ---------------------------------------------------------
    def take(self, idx: np.ndarray) -> "Relation":
        return Relation({k: v[idx] for k, v in self.columns.items()})

    def select(self, names: Iterable[str]) -> "Relation":
        """Column subset that SHARES this relation's device-cache state.

        A selected sub-relation holds the same numpy column objects, so its
        device uploads and key-cardinality sketches are interchangeable with
        the parent's: both point at the parent's cache dicts (same object,
        not a copy).  Projection-pruned scans therefore reuse columns the
        parent already uploaded — and uploads made through a pruned scan
        warm the parent and every sibling selection, across queries, even
        though the planner builds a fresh sub-relation per query.
        (Entries are token-checked per column, so staleness detection is
        unchanged; ``invalidate_device_cache`` on the *parent* drops the
        shared state for all of them.)
        """
        sub = Relation({k: self.columns[k] for k in names})
        for attr in ("_device_cache", "_key_stats", "_packed_cols",
                     "_sel_cache", "_partition_cache", "_layout_cache"):
            sub.__dict__[attr] = self.__dict__.setdefault(attr, {})
        return sub

    def rename(self, mapping: Mapping[str, str]) -> "Relation":
        return Relation({mapping.get(k, k): v for k, v in self.columns.items()})

    def concat(self, other: "Relation") -> "Relation":
        if set(self.names) != set(other.names):
            raise ValueError(f"schema mismatch: {self.names} vs {other.names}")
        return Relation(
            {k: np.concatenate([self.columns[k], other.columns[k]]) for k in self.names}
        )

    def head(self, n: int) -> "Relation":
        return Relation({k: v[:n] for k, v in self.columns.items()})

    def equals(self, other: "Relation") -> bool:
        """Column-order-insensitive equality (spill round-trips alphabetize)."""
        return set(self.names) == set(other.names) and all(
            np.array_equal(self.columns[k], other.columns[k]) for k in self.names
        )

    def sort_canonical(self) -> "Relation":
        """Row/column-order-insensitive canonical form (result-set comparison)."""
        names = sorted(self.names)
        keys = [self.columns[k] for k in reversed(names)]
        order = np.lexsort(keys)
        return Relation({k: self.columns[k][order] for k in names})
