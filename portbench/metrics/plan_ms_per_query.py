"""``plan_ms_per_query``: the front end and planner (``core/session.py``,
``core/planner.py``) and the path decisions (``core/executor.py``'s
``_try_fused`` and ``_priced``, ``core/path_selector.py``).

Mean over the window's answered queries of the host time of their
``plan`` span (the logical plan, its rewrite and its stages) and their
``decide`` spans (the fragment matched, the broker's quotes, the
selector's choice), program spans on the host clock
(``portbench/spans.py``).  It should move ``query_p95_ms``: every query
pays it before its device work.
"""
from portbench import spans


def read(run):
    return spans.per_query(run, ("plan", "decide"))
