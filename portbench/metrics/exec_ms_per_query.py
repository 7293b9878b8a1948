"""``exec_ms_per_query``: execution (``core/executor.py``, ``core/fused.py``).

Mean over the window's answered queries of the sum of their operators'
``OpMetrics.wall_s``, the program's own host-clock span of each operator
(lease wait included, as the program counts it).  It should move
``queries_per_s``.
"""


def read(run):
    qs = run.answered()
    if not qs:
        return None
    return 1e3 * sum(sum(op.wall_s for op in q.ops) for q in qs) / len(qs)
