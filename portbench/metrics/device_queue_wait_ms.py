"""``device_queue_wait_ms``: the broker's device queue (``core/resource_broker.py``).

Mean over the window's answered queries of the seconds each spent queued
for its device leases: the sum of its operators' ``OpMetrics.queue_wait_s``,
a span the program times on the host clock.  It should move
``query_p95_ms``: with eight streams a query waits behind the others'
leases.
"""


def read(run):
    qs = run.answered()
    if not qs:
        return None
    return 1e3 * sum(sum(op.queue_wait_s for op in q.ops) for q in qs) / len(qs)
