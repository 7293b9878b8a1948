"""Device-resident columnar relation with late materialization.

The seed engine lowered every intermediate back to a host-numpy
:class:`~repro_torch.core.relation.Relation` between operators — exactly the
"premature materialization" the paper argues against.  A
:class:`DeviceRelation` keeps columns as device tensors across operators
and carries two pieces of deferred state instead of moving payload bytes:

  * a **pending gather index** per column (late materialization): a join or
    sort does not shuffle payload columns, it composes an ``int`` index array;
    the gather runs on device only when a column is actually consumed;
  * a **validity mask** over the (statically shaped) physical rows: joins
    produce ``capacity``-padded index spaces, filters AND their predicate into
    the mask, and no compaction (a dynamic-shape operation that would need a
    host sync) ever happens on device.

Host materialization happens exactly once, at the query root, via
:meth:`to_host` — a single batched device→host copy for all columns plus the
mask.  Callers that track :class:`~repro_torch.core.metrics.OpMetrics` count that as
one host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import to_host, upload
from .relation import Relation

__all__ = ["DeviceColumn", "DeviceRelation"]


def _torch_dtype(name) -> torch.dtype:
    """torch dtype of a numpy dtype name (``"int64"`` → ``torch.int64``)."""
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


@dataclasses.dataclass(frozen=True)
class DeviceColumn:
    """A device array plus an optional pending gather index and decode hook.

    The logical column is ``decode(base[gather])`` (gather/decode optional),
    but both are deferred until :meth:`force` — composing two takes costs
    one index gather, never a payload gather, and a packed column
    (:mod:`repro_torch.core.codec_device`) stays narrow codes through every lazy
    composition: the decode to logical width runs on device only when a
    consumer actually reads values (the decode-at-fetch rule).
    """

    base: torch.Tensor
    gather: Optional[torch.Tensor] = None
    # device-side decode applied after the gather (packed codes → logical
    # values); None for plain columns.  ``out_dtype`` is the decoded dtype.
    decode: Optional[object] = None
    out_dtype: Optional[object] = None

    def force(self) -> torch.Tensor:
        arr = self.force_codes()
        if self.decode is not None:
            arr = self.decode(arr)
        return arr

    def force_codes(self) -> torch.Tensor:
        """The physical (still-packed) column — code-domain consumers
        (group-by factorization) skip the decode entirely."""
        if self.gather is None:
            return self.base
        return self.base[self.gather]

    def take_lazy(self, idx: torch.Tensor) -> "DeviceColumn":
        if self.gather is None:
            return DeviceColumn(self.base, idx, self.decode, self.out_dtype)
        return DeviceColumn(self.base, self.gather[idx],
                            self.decode, self.out_dtype)

    @property
    def num_rows(self) -> int:
        arr = self.gather if self.gather is not None else self.base
        return int(arr.shape[0])

    @property
    def dtype(self):
        if self.decode is not None and self.out_dtype is not None:
            return _torch_dtype(self.out_dtype)
        return self.base.dtype


class DeviceRelation:
    """Columns on device; physical rows are static, logical rows are masked."""

    def __init__(self, columns: Dict[str, DeviceColumn],
                 valid: Optional[torch.Tensor] = None):
        if not columns:
            raise ValueError("DeviceRelation needs at least one column")
        lengths = {k: c.num_rows for k, c in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged device columns: {lengths}")
        self.columns = columns
        self.valid = valid  # None = all physical rows are logical rows

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_host(rel: Relation, device) -> "DeviceRelation":
        dev = torch.device(device)
        return DeviceRelation(
            {k: DeviceColumn(upload(v, dev)) for k, v in rel.columns.items()})

    @staticmethod
    def from_arrays(cols: Mapping[str, torch.Tensor],
                    valid: Optional[torch.Tensor] = None) -> "DeviceRelation":
        return DeviceRelation({k: DeviceColumn(v) for k, v in cols.items()},
                              valid=valid)

    @staticmethod
    def from_codes(cols: Mapping[str, object]) -> "DeviceRelation":
        """Lift packed device columns (:class:`~repro_torch.core.codec_device.
        DeviceCodes`) into a relation of decode-deferred columns: storage
        stays at code width, the decode hook runs at :meth:`DeviceColumn.
        force` — i.e. only for columns a consumer actually touches."""
        out: Dict[str, DeviceColumn] = {}
        for k, dc in cols.items():
            if dc.encoding == "raw":
                out[k] = DeviceColumn(dc.codes)
            else:
                out[k] = DeviceColumn(dc.codes, decode=dc.decode,
                                      out_dtype=dc.layout.logical_dtype)
        return DeviceRelation(out)

    # -- properties --------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.columns.keys())

    @property
    def num_physical_rows(self) -> int:
        return next(iter(self.columns.values())).num_rows

    def __len__(self) -> int:
        # Upper bound on logical rows without a device sync; exact count
        # requires materializing the mask (the selector only needs scale).
        return self.num_physical_rows

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).base.device

    def row_bytes(self) -> int:
        return int(sum(c.dtype.itemsize for c in self.columns.values()))

    def col(self, name: str) -> torch.Tensor:
        """The logical column as a device array (runs the pending gather)."""
        return self.columns[name].force()

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.col(name)

    # -- transforms (all lazy / device-side, never a host sync) ------------
    def take_lazy(self, idx: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> "DeviceRelation":
        """Row selection by device index array; payload gathers stay pending.

        Columns sharing one physical gather array compose it once.
        """
        composed: Dict[int, torch.Tensor] = {}
        out: Dict[str, DeviceColumn] = {}
        for k, c in self.columns.items():
            if c.gather is None:
                out[k] = DeviceColumn(c.base, idx, c.decode, c.out_dtype)
                continue
            key = id(c.gather)
            if key not in composed:
                composed[key] = c.gather[idx]
            out[k] = DeviceColumn(c.base, composed[key], c.decode,
                                  c.out_dtype)
        new_valid = valid
        if new_valid is None and self.valid is not None:
            new_valid = self.valid[idx]
        return DeviceRelation(out, valid=new_valid)

    def with_valid(self, valid: torch.Tensor) -> "DeviceRelation":
        return DeviceRelation(dict(self.columns), valid=valid)

    def mask_and(self, mask: torch.Tensor) -> "DeviceRelation":
        valid = mask if self.valid is None else (self.valid & mask)
        return DeviceRelation(dict(self.columns), valid=valid)

    def select(self, names: Iterable[str]) -> "DeviceRelation":
        return DeviceRelation({k: self.columns[k] for k in names},
                              valid=self.valid)

    # -- the single host-materialization point -----------------------------
    def to_host(self) -> Relation:
        """Materialize to a host Relation with ONE batched device→host fetch."""
        names = list(self.columns)
        forced = [self.columns[k].force() for k in names]
        if self.valid is not None:
            *cols, valid = to_host(forced + [self.valid])
            keep = np.nonzero(valid)[0]
            return Relation({k: v[keep] for k, v in zip(names, cols)})
        cols = to_host(forced)
        return Relation({k: np.array(v) for k, v in zip(names, cols)})
