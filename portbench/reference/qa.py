"""Q-a's plain reference: the sum of ``l_extendedprice`` over Q3's join
core, in int64 cents, exact."""
from __future__ import annotations

import torch

from .q3 import joined_rows


def answer(tables, params, device, dtype=torch.int64):
    """The exact sum as an int.  ``tables`` maps each table's name to its
    host columns; ``dtype`` is the type the sum is taken in: int64 is the
    query's; a lower precision is the control's."""
    rows, _ = joined_rows(tables, int(params["date"]), device)
    lineitem = tables["lineitem"]
    price = torch.as_tensor(lineitem["l_extendedprice"]).to(device)[rows]
    total = price.to(dtype).sum(dtype=dtype)
    return total.item()
