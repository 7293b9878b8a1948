"""A GROUP BY, plainly: the distinct keys in ascending order, each with
its sums and counts, in int64 and exact."""
from __future__ import annotations

import torch

from .q3 import upload


def grouped(table, key: str, values, device, dtype=torch.int64):
    """``{column: numpy array}`` of ``GROUP BY key`` over ``table`` (a
    table's host columns): ``key``, and ``<fn>_<column>`` for each
    ``column: fn`` of ``values`` (``sum`` or ``count``).  ``dtype`` is the
    type the aggregates are taken in: int64 is the query's; a lower
    precision is the control's."""
    cols = upload(table, [key] + [c for c, fn in values.items()
                                  if fn == "sum"], device)
    keys, inv = torch.unique(cols[key], sorted=True, return_inverse=True)
    out = {key: keys.cpu().numpy()}
    for col, fn in values.items():
        if fn == "sum":
            acc = torch.zeros(len(keys), dtype=dtype, device=keys.device)
            acc.index_add_(0, inv, cols[col].to(dtype))
        elif fn == "count":
            acc = torch.bincount(inv, minlength=len(keys)).to(dtype)
        else:
            raise ValueError(f"no plain {fn!r}")
        out[f"{fn}_{col}"] = acc.cpu().numpy()
    return out
