"""``fetch_mib_per_query``: the device's fetch (``device.py``'s
``to_host``).

Mean over the window's answered queries of the bytes their fetches
handed back to the host, in MiB: the ``bytes`` count on each ``fetch``
span, the arrays the host receives (a program counter,
``portbench/spans.py``).  It should move ``queries_per_s``: the copy to
the host is device time.
"""
from portbench import spans


def read(run):
    return spans.per_query(run, ("fetch",),
                           lambda s: s.attrs.get("bytes", 0) / (1 << 20))
