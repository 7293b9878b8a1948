"""``queries_per_s``: the queries answered within the window over the
window's seconds, on the host clock."""


def read(run):
    return len(run.answered_in_window()) / run.seconds
