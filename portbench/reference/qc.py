"""Q-c's plain reference: each supplier's revenue and line count, by
``l_suppkey`` ascending, in int64, exact."""
from __future__ import annotations

import torch

from .group import grouped


def answer(tables, params, device, dtype=torch.int64):
    """``{column: numpy array}``.  ``tables`` maps each table's name to its
    host columns; ``dtype`` is the type the aggregates are taken in: int64
    is the query's; a lower precision is the control's."""
    return grouped(tables["lineitem"], "l_suppkey",
                   {"l_extendedprice": "sum", "l_quantity": "count"},
                   device, dtype)
