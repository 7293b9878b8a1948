"""``device_idle_pct``: the device (``device.py``).

From the profiler's trace of the whole measured window: 100 minus the
cards' busy time (the union of their kernels, copies and fills) over the
number of cards times the window.  It should move ``queries_per_s``: an
idle card waits for the host.
"""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.cards == 0 or tr.busy_s <= 0:
        return None
    return 100.0 - 100.0 * tr.busy_s / tr.window_s
