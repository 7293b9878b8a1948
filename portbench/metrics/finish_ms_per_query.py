"""``finish_ms_per_query``: execution's host side after the fetch
(``core/fused.py``'s ``run_fused``, ``core/device_relation.py``).

Mean over the window's answered queries of the host time of their
``finish`` spans: the overflow and duplicate checks, the filter of the
valid rows (``np.nonzero``) and the answer built (program spans on the
host clock, ``portbench/spans.py``).  The lease is released by then, so
it adds to each query's latency but not to the card's: it should move
``query_p95_ms``.
"""
from portbench import spans


def read(run):
    return spans.per_query(run, ("finish",))
