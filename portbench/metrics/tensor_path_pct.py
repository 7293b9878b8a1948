"""``tensor_path_pct``: the path decision (``core/path_selector.py``,
``core/cost_model.py``).

Share of the operators run in the window whose ``OpMetrics.path`` is
``"tensor"`` (the card) rather than ``"linear"`` (the host's spilling
path), a count the program keeps.  It should move ``queries_per_s``: at
1 MiB of work_mem a linear operator spills.
"""


def read(run):
    ops = [op for q in run.answered() for op in q.ops]
    if not ops:
        return None
    return 100.0 * sum(op.path == "tensor" for op in ops) / len(ops)
