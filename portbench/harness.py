"""One run of one benchmark cell: data from the seed, set-up, a measured
window of traffic, the comparison with the plain reference, and the result
line.

Everything is found by name.  ``BENCHMARK.json`` names each cell's
configuration (``portbench/configs/<config>.json``) and traffic mix
(``portbench/traffic/<mix>.json``).  The configuration names its data
generator (``portbench/data/<data>.py``: ``make_tables(cfg, seed,
device)``, a dict of named tables), which every table the engine serves
and every reference reads comes from.  The mix names its loop
(``portbench/loops/<loop>.py``: ``warm`` and ``window``) and its queries,
each built through the engine's session API by
``portbench/queries/<query>.py`` and answered plainly by
``portbench/reference/<query>.py``.  Every metric, end-to-end or
per-layer, is read by ``portbench/metrics/<metric>.py``, which returns
nothing where it finds nothing to read.  The CPU tests find the rest the
same way: a query names in ``FAULTS`` the faults its answer must fail
under, each planted by ``portbench/faults/<fault>.py``, and a
configuration may give its tables' sizes for those tests under
``"tiny"`` (``portbench/tiny.py``).  A new cell, configuration,
deployment's data, loop, query, fault or metric is new files and
entries, never an edit here.

The system under test is ``repro_torch``: its ``QueryServer.submit`` runs
``Session.execute`` (planner, path selector, broker and governor,
executor, the fused fragment, the kernels, one fetch).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in a run: JAX, and the JAX
#: package the engine was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds a loop may take past the window's close to return its last
#: query before the run fails
GRACE_S = 120.0
#: keys of a configuration that are the engine's ``QueryServer`` options
SERVER_OPTIONS = ("total_mem", "work_mem", "policy", "min_grant",
                  "full_grant_wait_s", "grant_policy", "queue_aware",
                  "device_max_batch", "reservations", "max_shards", "tiers",
                  "guards")


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: dict, name: str):
    """``(cell, configuration entry)`` of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def config_of(entry: dict, root: Path = ROOT) -> dict:
    return load_json(root / entry["file"])


def traffic_of(name: str) -> dict:
    return load_json(PKG / "traffic" / f"{name}.json")


def _load_file(kind: str, name: str):
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r} ({path} is missing)")
    mod_name = f"portbench.{kind}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def data_module(name: str):
    """``portbench/data/<name>.py``: ``make_tables(cfg, seed, device)``,
    ``{table: {column: tensor}}`` on ``device``."""
    return _load_file("data", name)


def loop_module(name: str):
    """``portbench/loops/<name>.py``: ``warm(server, built, traffic, seed)``
    and ``window(server, built, traffic, seed)``, whose result has
    ``release(seconds)``, ``join(timeout)`` and ``queries()``."""
    return _load_file("loops", name)


def query_module(name: str):
    """``portbench/queries/<name>.py``: ``build(session, params)``."""
    return _load_file("queries", name)


def metric_module(name: str):
    """``portbench/metrics/<name>.py``: ``read(run)``, a number or None."""
    return _load_file("metrics", name)


def reference_module(name: str):
    """``portbench/reference/<name>.py``: ``answer(tables, params,
    device)``."""
    return importlib.import_module(f"portbench.reference.{name}")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is forbidden."""
    names = list(sys.modules) if names is None else names
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Records of a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Op:
    op: str
    path: str
    wall_s: float
    queue_wait_s: float
    spill_bytes: int
    devices: int = 1     # lanes of a sharded fragment, else 1


@dataclasses.dataclass
class Query:
    stream: int
    seq: int
    name: str
    t0: float            # when it was due: its call in a closed loop
    t1: float            # its answer on the host, or its failure
    error: Optional[str] = None
    ops: List[Op] = dataclasses.field(default_factory=list)
    scalar: Optional[float] = None
    rows: object = None      # the relation answer, where it was kept


def ops_of(res) -> List[Op]:
    """The operators of a query's result, as the program counted them."""
    return [Op(m.op, m.path, m.wall_s, m.queue_wait_s,
               m.spill.bytes_written, m.devices) for m in res.metrics]


@dataclasses.dataclass
class Run:
    """What the readers of metrics see."""

    config: dict
    rows: Dict[str, int]     # rows of each table
    modules: Dict[str, object]
    queries: List[Query]     # every query started in the window
    cold_query_s: Optional[float]
    setup_s: float
    seconds: float           # the window's length
    window_start: float
    peak_bytes: int = 0      # allocated on the fullest card in the window
    trace: object = None
    #: rows of the reference's answer to each query of the mix that
    #: answers with rows (a GROUP BY's groups)
    answer_rows: Dict[str, int] = dataclasses.field(default_factory=dict)

    def answered(self) -> List[Query]:
        return [q for q in self.queries if q.error is None]

    def answered_in_window(self) -> List[Query]:
        end = self.window_start + self.seconds
        return [q for q in self.answered() if q.t1 <= end]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile with linear interpolation between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------

def program_device(cfg: dict, device):
    """What the engine is given: the first card, or the cell's cards for a
    sharded deployment, unless the caller names devices."""
    if device is not None:
        return device
    if cfg.get("max_shards", 1) > 1:
        return tuple(f"cuda:{i}" for i in range(cfg["cards"]))
    return "cuda:0"


def cards_of(device) -> List[int]:
    """Indices of the CUDA cards among ``device``."""
    import torch

    devs = device if isinstance(device, tuple) else (device,)
    out = []
    for d in devs:
        d = torch.device(d)
        if d.type == "cuda":
            out.append(d.index or 0)
    return sorted(set(out))


def host_tables(tables) -> Dict[str, Dict]:
    """Each table's columns as numpy arrays in host memory, as a user of
    the engine holds them."""
    return {name: {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
                   for k, v in cols.items()}
            for name, cols in tables.items()}


def table_rows(tables) -> Dict[str, int]:
    return {name: len(next(iter(cols.values())))
            for name, cols in tables.items()}


def _tally(items) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for it in items:
        out[it] = out.get(it, 0) + 1
    return dict(sorted(out.items()))


def synchronize(cards: List[int]) -> None:
    import torch

    for c in cards:
        torch.cuda.synchronize(c)


def setup(cfg: dict, traffic: dict, seed: int, device, split: dict):
    """Tables from the seed, the server over them, the cold queries and the
    warm-up.  Returns ``(server, built queries, host tables, each query's
    cold seconds)``; ``split`` gets the seconds of each step."""
    import torch

    from repro_torch import device as rdev
    from repro_torch.core import QueryServer

    cards = cards_of(device)
    gen_dev = f"cuda:{cards[0]}" if cards else "cpu"
    t = time.perf_counter()
    tables = host_tables(data_module(cfg["data"]).make_tables(cfg, seed,
                                                              gen_dev))
    if cards:
        torch.cuda.empty_cache()
    split["generate_s"] = time.perf_counter() - t

    t = time.perf_counter()
    server = QueryServer(dict(tables), device=device,
                         **{k: cfg[k] for k in SERVER_OPTIONS if k in cfg})
    mix = traffic["mix"]
    built = {name: query_module(name).build(server.session, traffic["params"])
             for name in mix}
    split["register_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if cards:
        rdev.kernel_library("segment_join")   # builds every kernel once
    split["kernel_build_s"] = time.perf_counter() - t

    cold = {}
    for name in mix:
        t = time.perf_counter()
        server.submit(built[name])
        if cards:
            synchronize(cards)
        cold[name] = time.perf_counter() - t
    split["cold_s"] = sum(cold.values())

    t = time.perf_counter()
    loop_module(traffic["loop"]).warm(server, built, traffic, seed)
    if cards:
        synchronize(cards)
    split["warmup_s"] = time.perf_counter() - t
    split["nvcc_s"] = rdev.build_seconds()
    return server, built, tables, cold


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def compared(tables, traffic: dict, queries: List[Query], device,
             answer_rows: Optional[Dict[str, int]] = None):
    """``[(name, kind, value)]``: each query of the mix's answers in the
    window against its plain reference, worked out on ``device``.  Where
    given, ``answer_rows`` gets the rows of each reference answer that is
    a relation."""
    from .reference import compare

    numbers = []
    for name in traffic["mix"]:
        want = reference_module(name).answer(tables, traffic["params"],
                                             device)
        mine = [q for q in queries if q.name == name and q.error is None]
        if isinstance(want, dict):
            n_rows = len(next(iter(want.values())))
            if answer_rows is not None:
                answer_rows[name] = n_rows
            kept = [q.rows for q in mine if q.rows is not None]
            wrong = (sum(compare.rows_wrong(r, want) for r in kept)
                     if kept else n_rows)
            numbers.append((f"{name}_rows_wrong", "rows_wrong", wrong))
        else:
            err = (max(compare.scalar_err(q.scalar, want) for q in mine)
                   if mine else math.inf)
            numbers.append((f"{name}_abs_err", "abs_err", err))
    return numbers


def read_metrics(entries, run: Run, units: Dict[str, str]) -> dict:
    """Each metric of ``entries`` its reader finds something for."""
    out = {}
    for m in entries:
        value = metric_module(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": units[m["name"]]}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, bench: Optional[dict] = None,
             config: Optional[dict] = None):
    """One run of cell ``cell_name``.  Returns ``(result, info, checks)``:
    the result line's object, the facts printed on the line before it, and
    the numbers compared with their limits.

    ``device`` and ``config`` replace the cell's cards and configuration
    (the CPU tests run a tiny deployment on ``"cpu"``)."""
    import torch

    from .reference import compare

    bench = benchmark() if bench is None else bench
    cell, entry = cell_of(bench, cell_name)
    cfg = config_of(entry) if config is None else config
    traffic = traffic_of(cell["traffic"])
    mix = traffic["mix"]
    device = program_device(cfg, device)
    cards = cards_of(device)
    split: Dict[str, float] = {}
    split["import_s"] = time.perf_counter() - t_start
    server, built, tables, cold = setup(cfg, traffic, seed, device, split)

    loop = loop_module(traffic["loop"]).window(server, built, traffic, seed)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW_SPAN

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cards else []))
        prof.start()
        span = record_function(WINDOW_SPAN)
        span.__enter__()
        opened = time.perf_counter()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    t_w0 = loop.release(seconds)
    setup_s = t_w0 - t_start
    loop.join(seconds + GRACE_S)
    synchronize(cards)
    if trace:
        span.__exit__(None, None, None)
        prof.stop()
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
               default=0)
    queries = sorted(loop.queries(), key=lambda q: q.t0)
    over_budget = (server.governor.stats().over_budget_events
                   if server.governor is not None else 0)
    del server, built, loop
    gc.collect()
    if cards:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    answer_rows: Dict[str, int] = {}
    numbers = compared(tables, traffic, queries,
                       f"cuda:{cards[0]}" if cards else "cpu", answer_rows)
    failed = [q for q in queries if q.error is not None]
    numbers.append(("failed", "failed", len(failed)))
    numbers.append(("over_budget", "over_budget", over_budget))
    checks, correct = compare.checks(numbers)
    for q in queries:
        q.rows = None

    run = Run(config=cfg, rows=table_rows(tables),
              modules={n: query_module(n) for n in mix}, queries=queries,
              cold_query_s=cold[mix[0]], setup_s=setup_s, seconds=seconds,
              window_start=t_w0, peak_bytes=peak, answer_rows=answer_rows)
    del tables
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if trace:
        from . import trace as tr

        t = time.perf_counter()
        run.trace = tr.reduce(prof, cards,
                              [(q.name, q.t0, q.t1) for q in queries], opened)
        reduce_s = time.perf_counter() - t
        metrics = read_metrics(bench["per_layer"], run, units)
    else:
        metrics = read_metrics(bench["end_to_end"], run, units)

    dev = {"platform": "gpu" if cards else "cpu",
           "kind": (torch.cuda.get_device_name(cards[0]) if cards
                    else "cpu"),
           "count": len(cards), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(queries),
              "failed": len(failed), "metrics": metrics, "device": dev}
    info = {"cell": cell_name, "seed": seed, "seconds": seconds,
            "trace": int(trace), "setup_s": setup_s, "setup": split,
            "cold_ms": {k: 1e3 * v for k, v in cold.items()},
            "answered_in_window": len(run.answered_in_window()),
            "spilled_bytes": sum(op.spill_bytes for q in queries
                                 for op in q.ops),
            "paths": _tally(f"{op.path}/{op.devices}" for q in queries
                            for op in q.ops)}
    if failed:
        info["first_failure"] = failed[0].error
    if trace:
        t = run.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
        info["trace_launches"] = t.launches
        info["trace_kernels"] = t.kernels
        info["trace_reduce_s"] = reduce_s
    result["checks"] = checks
    return result, info, checks
