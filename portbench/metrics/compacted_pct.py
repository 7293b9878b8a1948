"""``compacted_pct``: execution's survivor bucket (``core/fused.py``'s
``run_fused``).

Share of the window's answered queries whose fused fragment ran on a
survivor bucket smaller than its join's capacity: the ``bucket`` and
``capacity`` counts on the last ``launch`` span of each query (program
counters, ``portbench/spans.py``).  There the program compacted the join
slots that passed the filter before the sort, the gathers and the fetch,
and so moved fewer bytes and sorted fewer rows: it should move
``queries_per_s``.  A query with no launch (the host's linear path)
counts as not compacted, as does the sharded fragment, whose launches
carry their capacity as their bucket; a program whose launches carry no
``bucket`` reads None.
"""
from portbench import spans


def read(run):
    queries = spans.answered(run)
    launches = [s for qs in queries.values() for s in qs
                if s.name == "launch"]
    if not queries or (launches
                       and not any("bucket" in s.attrs for s in launches)):
        return None
    last = {}
    for s in launches:
        if "bucket" in s.attrs and (s.query not in last
                                    or s.t0_ns >= last[s.query].t0_ns):
            last[s.query] = s
    compacted = sum(s.attrs["bucket"] < s.attrs["capacity"]
                    for s in last.values())
    return 100.0 * compacted / len(queries)
