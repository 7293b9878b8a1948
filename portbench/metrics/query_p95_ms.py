"""``query_p95_ms``: the 95th percentile of the latencies of every query
started in the window, on the host clock, from the call to its answer on
the host.  A failed query is an answer that never came: it counts as
longer than any other, and a percentile that falls on one reads as the
window's length.
"""
import math

from portbench.harness import percentile


def read(run):
    if not run.queries:
        return 1e3 * run.seconds
    lat = [(q.t1 - q.t0) if q.error is None else math.inf
           for q in run.queries]
    p95 = percentile(lat, 95)
    return 1e3 * (run.seconds if p95 == math.inf else p95)
