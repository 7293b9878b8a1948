"""The frozen roofline arithmetic and the join's byte count."""
import pytest

from portbench import roofline
from portbench.trace import Trace, _union


def test_join_bytes_is_the_hand_sum():
    # 3 build keys and 5 probe keys of 8 bytes read, 5 build rows of 4
    # bytes written
    assert roofline.join_bytes(3, 5) == 3 * 8 + 5 * 8 + 5 * 4 == 84
    assert roofline.join_bytes(0, 0) == 0


def test_group_bytes_is_the_hand_sum():
    # 10 rows of an 8-byte key and a 4-byte summed column read, 3 groups of
    # a key and 2 aggregates written at 8 bytes
    assert roofline.group_bytes(10, [8, 4], 3, 2) == \
        10 * 8 + 10 * 4 + 3 * 3 * 8 == 192
    # a count reads no column
    assert roofline.group_bytes(10, [8], 1, 1) == 10 * 8 + 2 * 8 == 96
    assert roofline.group_bytes(0, [8], 0, 1) == 0


@pytest.mark.parametrize("query", ["qc", "qe"])
def test_group_names_the_tables_widths(query, monkeypatch):
    """A query's ``GROUP`` reads columns of its table at the widths the
    card's column cache holds them in at the deployment's domains (the
    engine's own choice of layout, on columns drawn at the configuration's
    scale), and names the GROUP BY its query runs."""
    from repro_torch.core.codec_device import choose_layout

    from portbench import harness, tiny

    monkeypatch.delenv("REPRO_DEVICE_COMPRESS", raising=False)
    g = harness.query_module(query).GROUP
    _, entry = harness.cell_of(tiny.bench(), "tpch10-groupby-8streams")
    cfg = dict(harness.config_of(entry))
    cfg.update({k: v for k, v in tiny.TINY.items() if k != "scale"})
    tables = harness.host_tables(
        harness.data_module(cfg["data"]).make_tables(cfg, 3, "cpu"))
    table = tables[g["table"]]
    summed = [c for c, fn in g["values"].items() if fn == "sum"]
    assert list(g["widths"]) == [g["key"]] + summed
    for col, width in g["widths"].items():
        layout, _ = choose_layout(table[col])
        assert layout.code_itemsize == width, (col, layout)
    assert set(g["values"]) <= set(table)


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3_350_000) == pytest.approx(1e-6)
    assert roofline.least_seconds(0, 67_000_000) == pytest.approx(1e-6)
    assert roofline.least_seconds(3_350_000, 670_000_000) == pytest.approx(1e-5)


def test_sf1_join_share_stays_under_the_roof():
    """At TPC-H SF1 (1,500,000 orders, 6,001,215 lines) the join's kernels
    took, on one H100 80GB HBM3 at 700 W (median of 20 CUDA-event pairs):
    the build side's radix pass 0.0895 ms, the table build 0.0772 ms and
    the probe in row order 0.0665 ms."""
    least = roofline.least_seconds(roofline.join_bytes(1_500_000, 6_001_215))
    assert least == pytest.approx(84_014_580 / 3.35e12)
    share = roofline.roofline_pct(least, (0.0895 + 0.0772 + 0.0665) * 1e-3)
    assert 0 < share < 100
    assert share == pytest.approx(10.76, abs=0.01)
    assert roofline.roofline_pct(least, 0.0) is None


def test_busy_time_is_the_union_of_device_intervals():
    assert _union([(5, 9), (0, 2), (1, 3), (8, 10)]) == [[0, 3], [5, 10]]
    t = Trace(window_s=2.0, cards=1, busy_s=0.5,
              kernel_s={"k_join_a": 0.25, "k_join_b": 0.125, "sort": 1.0},
              idle_gaps=[("qa: cudaStreamSynchronize", 0.5)], launches=3,
              kernels=3)
    assert t.kernel_time(["k_join"]) == 0.375
    b = t.breakdown()
    assert b["device_ops"][0] == ["sort", 1.0]
    assert b["idle_gaps"] == [["qa: cudaStreamSynchronize", 0.5]]


def test_reduce_reads_the_window_span_of_a_cpu_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            torch.arange(1000).sort()
    t = trace.reduce(prof, [], [("qa", 1.0, 2.0)], 1.0)
    assert t.window_s > 0 and t.busy_s == 0 and t.cards == 0
    assert t.kernels == 0 and t.idle_gaps == []
    host = trace._Spans([("aten::sort", 2, 9), ("aten::add", 0, 1)])
    queries = trace._Spans([("qb", 0, 10), ("qa", 5, 6)])
    assert trace._name_gap(1, 8, host, queries) == \
        "qb, 2 in flight: aten::sort"
    assert trace._name_gap(20, 30, host, queries) == \
        "no query in flight: no host call"


def test_groupby_roofline_reads_the_groupbys_over_every_kernel():
    from portbench import harness

    reader = harness.metric_module("groupby_roofline")
    trace = Trace(window_s=1.0, cards=1, busy_s=1.0,
                  kernel_s={"sort": 2e-6, "segment_sum": 2e-6,
                            "Memcpy DtoH (Device -> Pinned)": 1.0,
                            "Memset (Device)": 1.0},
                  idle_gaps=[], launches=2, kernels=2)
    modules = {n: harness.query_module(n) for n in ("qa", "qc", "qe")}

    def run(names):
        queries = [harness.Query(0, i, n, 1.0 + i, 1.9 + i)
                   for i, n in enumerate(names)]
        # the groups of each GROUP BY: the rows of its reference answer
        return harness.Run(config={}, rows={"lineitem": 1000, "orders": 10},
                           modules=modules, queries=queries,
                           cold_query_s=None, setup_s=0.0, seconds=1.0,
                           window_start=1.0, trace=trace,
                           answer_rows={"qc": 5, "qe": 4})

    # Q-c: a 4-byte key and a 4-byte price read, 5 groups of a key and 2
    # aggregates; Q-e: a 1-byte key, a 1-byte quantity and a 4-byte price
    # read, 4 groups of a key and 3 aggregates; Q-a does not group
    least = ((1000 * 8 + 5 * 3 * 8) + (1000 * 6 + 4 * 4 * 8)) / 3.35e12
    assert reader.read(run(["qc", "qa", "qe"])) == pytest.approx(
        100 * least / 4e-6)
    assert reader.read(run(["qa"])) is None
    untraced = run(["qc"])
    untraced.trace = None
    assert reader.read(untraced) is None
