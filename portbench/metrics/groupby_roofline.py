"""``groupby_roofline``: the GROUP BY's kernels (``core/aggregate.py``'s
``group_aggregate_device``: the sort of the key, ``segment_sum``'s kernels
in ``csrc/segment_join.cu``, ``scatter_reduce_``).

The least time the window's GROUP BYs need, over the device time of every
kernel in the traced window.  The least time counts, for each answered
query that groups, the bytes its GROUP BY must move
(``portbench.roofline.group_bytes``: the key and each summed column read
once at the widths the card's column cache holds them in, each group's
key and aggregates written once at 8 bytes) over the H100's 3.35 TB/s.
A query module names its GROUP BY in ``GROUP``; its groups are the rows
of the reference's answer (``Run.answer_rows``: the tables are read-only,
so every answer of one query has as many).  The device time is that of
every kernel but the copies and fills (``Memcpy``, ``Memset``): in a cell
whose queries all group, only the GROUP BYs run on the card, so the share
reads the same work whatever kernels carry it.  Where no query groups
there is nothing to read.  It should move ``queries_per_s``.
"""
from portbench.roofline import group_bytes, least_seconds, roofline_pct

#: device operations that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    if run.trace is None:
        return None
    grouping = [q for q in run.answered()
                if getattr(run.modules[q.name], "GROUP", None) is not None]
    if not grouping:
        return None
    least = 0.0
    for q in grouping:
        g = run.modules[q.name].GROUP
        least += least_seconds(group_bytes(
            run.rows[g["table"]], g["widths"].values(),
            run.answer_rows.get(q.name, 0), len(g["values"])))
    device_s = sum(s for k, s in run.trace.kernel_s.items()
                   if not k.startswith(NOT_KERNELS))
    return roofline_pct(least, device_s)
