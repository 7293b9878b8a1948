"""The harness on the CPU: finding things by name, the result line, the
refusal without a card, and what a run loads."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, tiny

ROOT = Path(__file__).resolve().parents[1]
CELLS = tiny.CELLS
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


def test_benchmark_entries_are_found_by_name():
    bench = harness.benchmark()
    names = {c["name"] for c in bench["configs"]}
    assert names == {w["config"] for w in bench["workloads"]}
    bench = tiny.bench()
    for entry in bench["configs"]:
        assert entry["file"].startswith("portbench/")
        cfg = harness.config_of(entry)
        for key in ("data", "work_mem", "total_mem", "policy",
                    "max_shards", "cards", "guarantees"):
            assert key in cfg, (entry["name"], key)
        assert callable(harness.data_module(cfg["data"]).make_tables)
    for cell in bench["workloads"]:
        _, entry = harness.cell_of(bench, cell["name"])
        assert harness.config_of(entry)["cards"] == cell["chips"]
        traffic = harness.traffic_of(cell["traffic"])
        loop = harness.loop_module(traffic["loop"])
        assert callable(loop.warm) and callable(loop.window)
        assert traffic["streams"] >= 1
        for q in traffic["mix"]:
            assert callable(harness.query_module(q).build)
            assert callable(harness.reference_module(q).answer)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
    assert {m["name"] for m in bench["end_to_end"]} == {
        "setup_s", "query_p95_ms", "queries_per_s"}
    with pytest.raises(KeyError):
        harness.cell_of(bench, "no-such-cell")
    for find in (harness.query_module, harness.data_module,
                 harness.loop_module, harness.metric_module):
        with pytest.raises(KeyError):
            find("no_such_name")


def test_configuration_keys_become_the_servers_options():
    """A configuration sets any option of the engine's server it names;
    the tables and the devices are the harness's own."""
    import inspect

    from repro_torch.core import QueryServer

    params = inspect.signature(QueryServer.__init__).parameters
    assert set(harness.SERVER_OPTIONS) <= set(params)
    assert not {"tables", "device", "session"} & set(harness.SERVER_OPTIONS)
    cfg = harness.config_of(harness.cell_of(tiny.bench(), CELLS[0])[1])
    assert {k for k in cfg if k in harness.SERVER_OPTIONS} == {
        "total_mem", "work_mem", "policy", "max_shards", "tiers", "guards"}


def test_percentile_is_numpys_linear_one():
    import numpy as np

    xs = [5.0, 1.0, 3.0, 2.0, 8.0, 13.0, 21.0]
    for q in (0, 50, 95, 100):
        assert harness.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))
    assert harness.percentile([1.0, float("inf")], 95) == float("inf")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_its_keys(cell, trace):
    result, info, checks = tiny.run(cell, trace=trace)
    keys = REQUIRED | {"checks"} | ({"breakdown"} if trace else set())
    assert set(result) == keys
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, checks
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = harness.benchmark()
    if trace:
        # the CPU has no device trace: the readers of the metrics taken
        # from it find nothing to read.  A metric with ``workloads`` is due
        # in those cells alone, one without in every cell
        host = [m for m in bench["per_layer"]
                if m["source"] != "device_trace"]
        due = {m["name"] for m in host
               if cell in m.get("workloads", [cell])}
        assert due <= set(result["metrics"]) <= {m["name"] for m in host}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in bench["end_to_end"]}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in checks.values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(result))
    assert info["spilled_bytes"] >= 0


def test_fixture_of_another_schema_runs_at_its_own_tiny_sizes():
    """The fixture cell's configuration names its own generator and its
    own tiny sizes, which the CPU tests run it at; its answers are right
    (its result line, sound run and faults are the parametrised tests')."""
    cfg = tiny.config("star-fixture")
    assert cfg["data"] != "tpch"
    assert {k: cfg[k] for k in cfg["tiny"]} == cfg["tiny"]
    tables = harness.data_module(cfg["data"]).make_tables(cfg, 7, "cpu")
    assert harness.table_rows(tables) == {"stores": cfg["tiny"]["stores"],
                                          "sales": cfg["tiny"]["sales"]}
    result, info, checks = tiny.run("star-fixture", policy="tensor")
    assert result["correct"] is True, checks
    assert set(info["paths"]) == {"tensor/1"}
    assert set(checks) == {"star_region_rows_wrong", "failed", "over_budget"}


def test_same_seed_same_stream_plan():
    plan = harness.loop_module("closed").stream_plan
    a = plan(2**33 + 1, 8, ["qa", "qb"])
    b = plan(2**33 + 1, 8, ["qa", "qb"])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert [r.random() for _, r in a] == [r.random() for _, r in b]


def _cli(*args, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal is for machines "
                    "without one")
    out = _cli("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from portbench import harness, tiny\n"
            "for cell in {cells!r}:\n"
            "    tiny.run(cell, trace=True)\n"
            "print(harness.forbidden_modules())\n").format(
                root=str(ROOT), src=str(ROOT / "src"), cells=CELLS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # a top-level name is compared whole: the port's name begins with the
    # JAX package's and is allowed
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "portbench"]) == []
    assert harness.forbidden_modules(["repro.core", "jaxlib.xla",
                                      "flax"]) == ["flax", "jaxlib", "repro"]
