"""The reader of ``compacted_pct`` on hand-made spans."""
import pytest

from portbench.test_portbench_spans import MS, S, _query, _read, _run


def _launched(qid, t0, *launches, error=None):
    """One query's spans, as ``_query`` makes them, with a ``launch`` span
    in its lease hold for each ``(capacity, bucket)`` of ``launches``, one
    after another."""
    out = _query(qid, t0, 1, 1, 1, 1, 10, 8, 1, error=error)
    hold = next(s for s in out if s.name == "lease_hold")
    for i, attrs in enumerate(launches):
        t = hold.t0_ns + i * MS
        out.append(S("launch", qid, qid + 90 + i, hold.id, t, t + MS,
                     dict(attrs)))
    return out


def test_compacted_pct_counts_each_querys_last_launch():
    run = _run(
        # compacted
        _launched(100, 0, {"capacity": 1 << 26, "bucket": 1 << 21})
        # uncompacted: the first run of its fragment
        + _launched(200, 50, {"capacity": 1 << 26, "bucket": 1 << 26})
        # a stale hint: compacted again on the re-run
        + _launched(300, 100, {"capacity": 1 << 26, "bucket": 16},
                    {"capacity": 1 << 26, "bucket": 1 << 21})
        # the host's linear path: no launch at all
        + _query(400, 150, 1, 1, 1, 0, 0, 0, 1)
        # failed: not among the answered queries
        + _launched(500, 200, {"capacity": 64, "bucket": 16},
                    error="RuntimeError"))
    assert _read("compacted_pct", run) == pytest.approx(50.0)


def test_compacted_pct_reads_zero_where_no_launch_compacted():
    run = _run(_launched(100, 0, {"capacity": 1024, "bucket": 1024})
               + _launched(200, 50, {"capacity": 64, "bucket": 16},
                           {"capacity": 128, "bucket": 128}))
    assert _read("compacted_pct", run) == 0


def test_compacted_pct_finds_nothing_without_buckets():
    assert _read("compacted_pct", _run([])) is None
    only_failed = _launched(1, 0, {"capacity": 64, "bucket": 16},
                            error="KeyError")
    assert _read("compacted_pct", _run(only_failed)) is None
    # a program whose launches carry no bucket
    older = _launched(1, 0, {"fresh": 0}) + _launched(20, 50, {"fresh": 1})
    assert _read("compacted_pct", _run(older)) is None


def test_compacted_pct_reads_zero_without_launches():
    """Every query on the host's linear path: none compacted."""
    run = _run(_query(1, 0, 1, 1, 1, 0, 0, 0, 1)
               + _query(20, 50, 1, 1, 1, 0, 0, 0, 1))
    assert _read("compacted_pct", run) == 0
