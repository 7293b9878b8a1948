"""The frozen roofline arithmetic and the join's byte count."""
import pytest

from portbench import roofline
from portbench.trace import Trace, _union


def test_join_bytes_is_the_hand_sum():
    # 3 build keys and 5 probe keys of 8 bytes read, 5 build rows of 4
    # bytes written
    assert roofline.join_bytes(3, 5) == 3 * 8 + 5 * 8 + 5 * 4 == 84
    assert roofline.join_bytes(0, 0) == 0


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
