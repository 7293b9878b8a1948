"""TPC-H Q3's join core, plainly: each line's order found by binary search
over the orders' sorted keys, then the two date predicates."""
from __future__ import annotations

import torch


def upload(table, names, device):
    """The named columns of a host table as tensors on ``device``."""
    return {k: torch.as_tensor(table[k]).to(device) for k in names}


def joined_rows(tables, date: int, device):
    """Positions in ``lineitem`` of the lines that Q3's join core keeps, in
    ``lineitem``'s order, and each one's ``o_orderdate``."""
    o = upload(tables["orders"], ("orderkey", "o_orderdate"), device)
    li = upload(tables["lineitem"], ("orderkey", "l_shipdate"), device)
    okey = o["orderkey"]
    if not bool((okey[1:] > okey[:-1]).all()):
        raise ValueError("orders must be sorted on orderkey, keys unique")
    pos = torch.clamp(torch.searchsorted(okey, li["orderkey"]),
                      max=okey.numel() - 1)
    hit = okey[pos] == li["orderkey"]
    od = o["o_orderdate"][pos]
    keep = hit & (od < date) & (li["l_shipdate"] > date)
    rows = torch.nonzero(keep).squeeze(1)
    return rows, od[rows]
