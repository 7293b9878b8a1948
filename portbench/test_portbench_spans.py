"""The readers of the program's spans, on hand-made spans, and the idle
gaps labelled with them on a hand-made trace."""
import dataclasses
from typing import Optional

import pytest

from portbench import harness, spans, trace
from portbench.harness import Query, Run

MS = 1_000_000  # ns


@dataclasses.dataclass
class S:
    name: str
    query: int
    id: int
    parent: Optional[int]
    t0_ns: int
    t1_ns: int
    attrs: dict = dataclasses.field(default_factory=dict)
    thread: int = 1


def _query(qid, t0, plan, decide, prepare, wait, hold, fetch_b, finish,
           error=None, group=1):
    """One query's spans from ``t0`` (ms), its steps one after another,
    each the given milliseconds long."""
    out, t, nid = [], t0 * MS, qid
    for name, ms in (("plan", plan), ("decide", decide),
                     ("prepare", prepare), ("lease_wait", wait),
                     ("lease_hold", hold), ("finish", finish)):
        nid += 1
        out.append(S(name, qid, nid, qid, t, t + ms * MS))
        if name == "lease_hold":
            out[-1].attrs["group"] = group
            out.append(S("fetch", qid, nid + 50, nid, t + ms * MS // 2,
                         t + ms * MS, {"bytes": fetch_b}))
        t += ms * MS
    root = S("query", qid, qid, None, t0 * MS, t + MS)
    if error:
        root.attrs["error"] = error
    return [root] + out


def _run(span_list, records=()):
    r = Run(config={}, rows={}, modules={}, queries=list(records),
            cold_query_s=None, setup_s=0.0, seconds=10.0, window_start=0.0)
    r.spans = span_list
    return r


def _read(name, run):
    return harness.metric_module(name).read(run)


SPAN_METRICS = ("plan_ms_per_query", "lease_hold_ms_per_query",
                "device_group_size", "fetch_mib_per_query",
                "fetch_ms_per_query", "finish_ms_per_query")


def test_readers_take_exact_means_of_the_answered_queries():
    run = _run(_query(100, 0, 1, 2, 3, 4, 10, 1 << 20, 5, group=2)
               + _query(200, 50, 3, 4, 5, 6, 30, 3 << 20, 7, group=4)
               # failed: each of its numbers would move every mean
               + _query(300, 100, 500, 500, 500, 500, 500, 1 << 30, 500,
                        error="RuntimeError", group=64))
    assert _read("plan_ms_per_query", run) == pytest.approx((3 + 7) / 2)
    assert _read("lease_hold_ms_per_query", run) == pytest.approx(20)
    assert _read("device_group_size", run) == pytest.approx(3)
    assert _read("fetch_mib_per_query", run) == pytest.approx(2)
    assert _read("fetch_ms_per_query", run) == pytest.approx((5 + 15) / 2)
    assert _read("finish_ms_per_query", run) == pytest.approx(6)


def test_readers_find_nothing_without_spans():
    for name in SPAN_METRICS:
        assert _read(name, _run([])) is None
        only_failed = _query(1, 0, 1, 1, 1, 1, 1, 8, 1, error="KeyError")
        assert _read(name, _run(only_failed)) is None


def test_a_query_without_a_lease_counts_zero():
    """The host's linear path takes no lease and fetches nothing."""
    root = S("query", 1, 1, None, 0, 10 * MS)
    plan = S("plan", 1, 2, 1, 0, 2 * MS)
    run = _run([root, plan])
    assert _read("plan_ms_per_query", run) == pytest.approx(2)
    for name in SPAN_METRICS[1:]:
        assert _read(name, run) == 0


def test_the_recorder_is_asked_once_and_only_for_the_window(monkeypatch):
    """Without ``run.spans`` the readers take the program's spans with its
    ``stop_spans()``, once, and keep the queries rooted in the window."""
    import sys
    import types

    calls = []
    fake = types.ModuleType(spans.RECORDER)
    before = _query(10, -5_000, 1, 1, 1, 1, 1, 8, 1)      # set-up's query
    inside = _query(20, 10, 1, 1, 1, 1, 1, 8, 1)
    fake.stop_spans = lambda: calls.append(1) or before + inside
    monkeypatch.setitem(sys.modules, spans.RECORDER, fake)
    run = Run(config={}, rows={}, modules={}, queries=[], cold_query_s=None,
              setup_s=0.0, seconds=10.0, window_start=0.0)
    assert {s.query for s in spans.of(run)} == {20}
    assert _read("plan_ms_per_query", run) == pytest.approx(2)
    assert calls == [1]
    # a program without the recorder
    monkeypatch.setitem(sys.modules, spans.RECORDER,
                        types.ModuleType(spans.RECORDER))
    run.spans = None
    assert spans.of(run) == [] and _read("device_group_size", run) is None


def test_coverage_of_the_steps_and_of_the_records():
    qs = _query(100, 0, 1, 2, 3, 4, 10, 8, 5)      # root 0..26 ms
    recs = [Query(0, 0, "qa", -0.001, 0.027)]       # 28 ms around it
    cov = spans.coverage(_run(qs, recs))
    assert cov["steps_share"] == pytest.approx(25 / 26)
    assert cov["steps_share_min"] == pytest.approx(25 / 26)
    assert cov["root_in_record"] == 1.0
    assert cov["root_cover"] == pytest.approx(26 / 28)
    assert spans.group_tally(_run(qs)) == {1: 1}


class _Ev:
    def __init__(self, name, dev, card, s, e):
        self._v = (name, dev, card, s, e)

    def name(self):
        return self._v[0]

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA if self._v[1]
                else torch.autograd.DeviceType.CPU)

    def device_index(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]


class _Prof:
    """What ``portbench.trace`` reads of a finished profiler session."""

    def __init__(self, events):
        evs = [_Ev(*e) for e in events]
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {
            "events": lambda _self: evs})()


def test_a_gap_keeps_its_label_and_gains_the_program_span():
    # the profiler's clock runs 5 s ahead of the host's; the window span
    # opens at host 1.0 s and closes at 2.0 s; it reads 1 s + 20 us long
    lo = 6_000_000_000
    hi = lo + 1_000_020_000
    events = [(trace.WINDOW_SPAN, False, -1, lo, hi),
              ("kernel_a", True, 0, lo, lo + 100 * MS),
              ("kernel_b", True, 0, lo + 300 * MS, lo + 950 * MS),
              ("cudaStreamSynchronize", False, -1, lo + 90 * MS,
               lo + 310 * MS)]
    # one query, 50..900 ms into the window; its fetch's pin span covers
    # the 100..300 ms gap, as do the spans it nests in: the innermost
    # names it
    q0 = int(1.05e9)
    sp = [S("query", 1, 1, None, q0, q0 + 850 * MS),
          S("lease_hold", 1, 2, 1, q0 + 10 * MS, q0 + 400 * MS),
          S("fetch", 1, 3, 2, q0 + 40 * MS, q0 + 300 * MS),
          S("pin", 1, 4, 3, q0 + 45 * MS, q0 + 260 * MS),
          S("launch", 1, 5, 2, q0 + 10 * MS, q0 + 40 * MS)]
    queries = [("qb", 1.05, 1.9)]
    old = trace.reduce(_Prof(events), [0], queries, 1.0)
    new, skew_us = spans.traced_gaps(trace._raw(_Prof(events)), [0],
                                     queries, sp, 1.0, 2.0)
    assert [s for _, s in new] == [s for _, s in old.idle_gaps]
    assert new[0][0] == old.idle_gaps[0][0] + " [fetch/pin]"
    assert old.idle_gaps[0][0] == "qb, 1 in flight: cudaStreamSynchronize"
    # the gap after kernel_b: no program span overlaps it, the label stays
    assert new[1][0] == old.idle_gaps[1][0] == (
        "no query in flight: no host call")
    assert skew_us == pytest.approx(20.0)
    to_trace, _ = spans.clock(lo, hi, 1.0, 2.0)
    assert to_trace(int(1.0e9)) == lo and to_trace(int(2.0e9)) == hi
