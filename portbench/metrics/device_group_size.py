"""``device_group_size``: the broker's device queue
(``core/resource_broker.py``).

The mean over the window's answered queries' device leases of the leases
admitted in the same coalesced group, joiners included: the ``group``
count on each ``lease_hold`` span, which the queue counts at the lease's
release (``portbench/spans.py``).  Where those queries held no lease (the
host's linear path) it reads 0.  A larger group shares the card among
more queries, each of which waits for the whole group's work: it should
move ``query_p95_ms``.
"""
from portbench import spans


def read(run):
    queries = spans.answered(run)
    if not queries:
        return None
    groups = [s.attrs.get("group", 1) for qs in queries.values()
              for s in qs if s.name == "lease_hold"]
    return sum(groups) / len(groups) if groups else 0.0
