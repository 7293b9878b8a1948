"""Q-b's plain reference: the rows of Q3's join core in the order
``o_orderdate, orderkey``, ties in ``lineitem``'s order."""
from __future__ import annotations

import torch

from .q3 import joined_rows


def answer(tables, params, device, dtype=torch.int64):
    """``{column: numpy array}``.  ``tables`` maps each table's name to its
    host columns; ``dtype`` is the type the prices pass through: int64 is
    the query's; a lower precision is the control's."""
    rows, od = joined_rows(tables, int(params["date"]), device)
    lineitem = tables["lineitem"]
    key = torch.as_tensor(lineitem["orderkey"]).to(device)[rows]
    price = torch.as_tensor(lineitem["l_extendedprice"]).to(device)[rows]
    # two stable sorts, least significant key first: lexicographic, with
    # ties left in row order
    perm = torch.sort(key, stable=True).indices
    perm = perm[torch.sort(od[perm], stable=True).indices]
    price = price.to(dtype)[perm].to(torch.int64)
    return {"orderkey": key[perm].cpu().numpy(),
            "b_o_orderdate": od[perm].cpu().numpy(),
            "l_extendedprice": price.cpu().numpy()}
