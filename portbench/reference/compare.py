"""The comparison that decides ``correct``: every number compared, with
its limit.

A scalar answer's number is its distance from the reference's; a rows
answer's is the count of rows that differ in any column, plus the rows
missing or left over.  The answers are exact (integer cents, rows and
their order), so each limit is 0: one cent or one row off fails the run.
A failed query is an answer that never came, and the governor's
over-budget events break the deployment's one memory guarantee.
"""
from __future__ import annotations

import math
import sys

import numpy as np

#: every limit, by the kind of number
LIMITS = {"abs_err": 0, "rows_wrong": 0, "failed": 0, "over_budget": 0}


def scalar_err(got, want: int) -> float:
    """Distance of a scalar answer from the exact reference; infinite for
    no answer or a value that is not a number."""
    if got is None:
        return math.inf
    got = float(got)
    if not math.isfinite(got):
        return math.inf
    return abs(got - float(want))


def rows_wrong(got, want) -> int:
    """Rows of ``got`` (a mapping of columns) that differ from ``want`` in
    any column, plus the difference in their counts."""
    n = len(next(iter(want.values())))
    try:
        cols = {k: np.asarray(got[k]) for k in want}
    except (KeyError, TypeError):
        return n
    m = min([n] + [len(c) for c in cols.values()])
    bad = np.zeros(m, dtype=bool)
    for k, w in want.items():
        bad |= cols[k][:m] != w[:m]
    return int(bad.sum()) + abs(max(len(c) for c in cols.values()) - n)


def checks(numbers):
    """``{name: {"value": v, "limit": l}}`` for ``numbers``, a list of
    ``(name, kind, value)``, and whether every value keeps its limit."""
    out, ok = {}, True
    for name, kind, value in numbers:
        limit = LIMITS[kind]
        ok = ok and value <= limit
        # JSON has no infinity: no answer reads as the largest float
        out[name] = {"value": min(value, sys.float_info.max),
                     "limit": limit}
    return out, ok
