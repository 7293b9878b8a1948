"""``setup_s``: process start to the window's start, on the host clock.

Imports, the tables made from the seed, the engine over them, the kernels
loaded (built by nvcc in a checkout's first run), the cold queries and
the warm-up.
"""


def read(run):
    return run.setup_s
