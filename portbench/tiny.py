"""A tiny deployment of each cell for the CPU tests: the cell's own
configuration, traffic and queries at a few thousand rows, on the CPU.

A configuration gives its tiny sizes under its own ``"tiny"`` key (rows
and domains of its tables); one without it takes :data:`TINY`, the sizes
of the TPC-H tables.  Each query names in ``FAULTS`` the planted faults
(``portbench/faults/<fault>.py``) its answer must fail under, and the
fault tests run each cell under each fault of its mix's queries.

Beside the cells of ``BENCHMARK.json`` it runs :data:`KEPT`: cells whose
files are kept under ``portbench/`` for a later benchmark to add (see
``PERF.md``, Open questions), so that the paths of the harness they take
stay tested, and a fixture cell of the tests alone."""
from __future__ import annotations

import time

from . import harness

#: rows and domains small enough for a run of a few seconds on the CPU,
#: for a configuration that gives no ``"tiny"`` sizes of its own
TINY = {"orders": 3000, "lineitem": 12000, "scale": 0.002}
#: the CPU's stand-ins for a cell's cards
DEVICES = {1: "cpu", 4: ("cpu",) * 4}
#: cells the tests run beside those of ``BENCHMARK.json``: the sharded
#: deployment over four cards, its configuration and traffic kept as
#: files, its cell not in ``BENCHMARK.json``; and a fixture of another
#: schema than TPC-H's, which no benchmark runs, to show that a cell of
#: any shape or schema runs through the harness and its faults from new
#: files and entries alone
KEPT = {
    "configs": [{"name": "tpch-sf10-8part-4cards",
                 "file": "portbench/configs/tpch-sf10-8part-4cards.json"},
                {"name": "star-fixture",
                 "file": "portbench/configs/star-fixture.json"}],
    "workloads": [{"name": "tpch10-q3sum-8part-4cards",
                   "config": "tpch-sf10-8part-4cards",
                   "traffic": "q3sum-8streams", "chips": 4},
                  {"name": "star-fixture", "config": "star-fixture",
                   "traffic": "star-fixture", "chips": 1}],
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
    """The cell's configuration at its ``"tiny"`` sizes, or at
    :data:`TINY`'s.  At this size the ``auto`` policy sends the joins to
    the host's linear path, so tests of the card's path pass
    ``policy="tensor"``."""
    cell, entry = harness.cell_of(bench(), cell_name)
    cfg = harness.config_of(entry)
    cfg.update(cfg.get("tiny", TINY))
    cfg.update(over)
    return cfg


def faults(cell_name: str) -> list:
    """The faults named by the queries of the cell's mix, in order."""
    cell, _ = harness.cell_of(bench(), cell_name)
    out = []
    for q in harness.traffic_of(cell["traffic"])["mix"]:
        for f in getattr(harness.query_module(q), "FAULTS", ()):
            if f not in out:
                out.append(f)
    return out


def run(cell_name: str, seed: int = 2**31 + 7, seconds: float = 0.3,
        trace: bool = False, **over):
    """``harness.run_cell`` on the CPU at the tiny size."""
    b = bench()
    cell, _ = harness.cell_of(b, cell_name)
    return harness.run_cell(cell_name, seed, seconds, trace,
                            time.perf_counter(), device=DEVICES[cell["chips"]],
                            bench=b, config=config(cell_name, **over))
