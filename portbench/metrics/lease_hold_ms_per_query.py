"""``lease_hold_ms_per_query``: the broker's device queue
(``core/resource_broker.py``).

Mean over the window's answered queries of the time they held device
leases: each ``lease_hold`` span runs from the lease's admission to its
release, the launch and the fetch inside it (program spans on the host
clock, ``portbench/spans.py``; 0 for a query that held none).  While a
lease is held its group has the card, so it should move
``query_p95_ms``.
"""
from portbench import spans


def read(run):
    return spans.per_query(run, ("lease_hold",))
