"""Q-e's plain reference: TPC-H Q1's sums and count by
``l_returnflag_linestatus`` ascending, in int64, exact."""
from __future__ import annotations

import torch

from .group import grouped


def answer(tables, params, device, dtype=torch.int64):
    """``{column: numpy array}``.  ``tables`` maps each table's name to its
    host columns; ``dtype`` is the type the aggregates are taken in: int64
    is the query's; a lower precision is the control's."""
    return grouped(tables["lineitem"], "l_returnflag_linestatus",
                   {"l_quantity": "sum", "l_extendedprice": "sum",
                    "orderkey": "count"}, device, dtype)
