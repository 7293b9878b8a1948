"""``peak_device_mib``: the broker's device queue (``core/resource_broker.py``).

``torch.cuda.max_memory_allocated`` over the traced window on the fullest
card, after ``reset_peak_memory_stats`` at the window's start.  The queue
admits queued dispatches of one compiled shape together (coalesced
groups, unbounded in these deployments), and the working sets of a
group's queries are live on the card at once: larger groups hold more
memory and wait less.  So it should move ``query_p95_ms``.  It is no
end-to-end metric: over a 51 s window its peak depends on the largest
group the streams happened to form, and two runs of one seed read up to
a third apart on one H100.
"""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / (1 << 20)
