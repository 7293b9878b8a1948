"""``cold_query_ms``: residency and partitioning (``core/table_cache.py``,
``core/codec_device.py``, ``core/partition.py``).

The first query after the tables are registered, timed on the host clock
during set-up: it uploads the columns it reads and, on a sharded
deployment, partitions them first.  It should move ``setup_s``.
"""


def read(run):
    if run.cold_query_s is None:
        return None
    return 1e3 * run.cold_query_s
