"""A tiny deployment of each cell for the CPU tests: the cell's own
configuration, traffic and queries at a few thousand rows, on the CPU.

Beside the cells of ``BENCHMARK.json`` it runs :data:`KEPT`: cells whose
files are kept under ``portbench/`` for a later benchmark to add (see
``PERF.md``, Open questions), so that the paths of the harness they take
stay tested."""
from __future__ import annotations

import time

from . import harness

#: rows and domains small enough for a run of a few seconds on the CPU
TINY = {"orders": 3000, "lineitem": 12000, "scale": 0.002}
#: the CPU's stand-ins for a cell's cards
DEVICES = {1: "cpu", 4: ("cpu",) * 4}
#: the sharded deployment over four cards, its configuration and traffic
#: kept as files, its cell not in ``BENCHMARK.json``
KEPT = {
    "configs": [{"name": "tpch-sf10-8part-4cards",
                 "file": "portbench/configs/tpch-sf10-8part-4cards.json"}],
    "workloads": [{"name": "tpch10-q3sum-8part-4cards",
                   "config": "tpch-sf10-8part-4cards",
                   "traffic": "q3sum-8streams", "chips": 4}],
}


def bench() -> dict:
    """``BENCHMARK.json`` with the cells of :data:`KEPT` added."""
    out = harness.benchmark()
    for key in ("configs", "workloads"):
        out[key] = out[key] + KEPT[key]
    return out


#: every cell the tests run
CELLS = [w["name"] for w in bench()["workloads"]]
#: those among them that span cards
SHARDED = [w["name"] for w in bench()["workloads"] if w["chips"] > 1]


def config(cell_name: str, **over) -> dict:
    """The cell's configuration at :data:`TINY`'s size.  At this size the
    ``auto`` policy sends the joins to the host's linear path, so tests of
    the card's path pass ``policy="tensor"``."""
    cell, entry = harness.cell_of(bench(), cell_name)
    cfg = harness.config_of(entry)
    cfg.update(TINY)
    cfg.update(over)
    return cfg


def run(cell_name: str, seed: int = 2**31 + 7, seconds: float = 0.3,
        trace: bool = False, **over):
    """``harness.run_cell`` on the CPU at the tiny size."""
    b = bench()
    cell, _ = harness.cell_of(b, cell_name)
    return harness.run_cell(cell_name, seed, seconds, trace,
                            time.perf_counter(), device=DEVICES[cell["chips"]],
                            bench=b, config=config(cell_name, **over))
