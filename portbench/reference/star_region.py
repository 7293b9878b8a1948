"""The fixture query's plain reference: each sale's store found by binary
search over the stores' sorted keys, then the GROUP BY of its region, in
int64."""
from __future__ import annotations

import torch

from .group import grouped
from .q3 import upload


def answer(tables, params, device, dtype=torch.int64):
    """``{column: numpy array}``.  ``tables`` maps each table's name to its
    host columns; ``dtype`` is the type the aggregates are taken in: int64
    is the query's; a lower precision is the control's."""
    stores = upload(tables["stores"], ("store", "s_region"), device)
    sales = upload(tables["sales"], ("store", "amount"), device)
    keys = stores["store"]
    if not bool((keys[1:] > keys[:-1]).all()):
        raise ValueError("stores must be sorted on store, keys unique")
    pos = torch.clamp(torch.searchsorted(keys, sales["store"]),
                      max=keys.numel() - 1)
    hit = keys[pos] == sales["store"]
    joined = {"b_s_region": stores["s_region"][pos[hit]],
              "amount": sales["amount"][hit], "store": sales["store"][hit]}
    return grouped(joined, "b_s_region", {"amount": "sum", "store": "count"},
                   device, dtype)
