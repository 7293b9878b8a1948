"""``fetch_ms_per_query``: the device's fetch (``device.py``'s
``to_host``).

Mean over the window's answered queries of the host time of their
``fetch`` spans: the outputs packed on the card, the pinned buffer
(its ``pin`` span), the copy and the wait for it (program spans on the
host clock, ``portbench/spans.py``).  It should move ``queries_per_s``.
"""
from portbench import spans


def read(run):
    return spans.per_query(run, ("fetch",))
