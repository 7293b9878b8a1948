"""The port's span recorder (``repro_torch.core.metrics``): off it records
nothing, on it nests each query's steps under the query's root span, keeps
concurrent queries apart, and the engine's layers leave the spans of a
fused query, a sharded one and the device queue's groups."""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch.core import QueryServer, fused  # noqa: E402
from repro_torch.core import metrics as M  # noqa: E402
from repro_torch.core.planner import plan_program  # noqa: E402
from repro_torch.core.resource_broker import DeviceQueue  # noqa: E402

#: the spans of a warm fused query, each at least once
FUSED_STEPS = {"query", "plan", "decide", "prepare", "lease_wait",
               "lease_hold", "launch", "fetch", "finish"}


@pytest.fixture
def recorder():
    """The recorder on for one test, and off after it whatever happens."""
    M.start_spans()
    try:
        yield
    finally:
        M.stop_spans()


def _tree(spans):
    return {s.id: s for s in spans}


def test_off_records_nothing_and_returns_the_shared_no_op():
    M.stop_spans()
    assert not M.spans_on()
    s = M.span("query")
    assert s is M.NO_SPAN and not s
    with M.span("plan") as p:
        assert p.set("bytes", 1) is M.NO_SPAN
    assert p.close() is M.NO_SPAN
    rows = torch.arange(10)
    out = D.to_host([rows])
    assert out[0].tolist() == list(range(10))
    assert M.stop_spans() == []


def test_nesting_gives_parents_and_one_query(recorder):
    with M.span("query") as q:
        with M.span("plan"):
            pass
        hold = M.span("lease_hold")
        with M.span("fetch") as f:
            f.set("bytes", 24)
            with M.span("pin"):
                pass
        hold.close()
        M.span("finish")          # left open: it ends with its parent
    with M.span("query") as q2:
        pass
    spans = M.stop_spans()
    by = {s.name: s for s in spans if s.query == q.id}
    assert set(by) == {"query", "plan", "lease_hold", "fetch", "pin",
                       "finish"}
    assert by["query"].parent is None and by["query"].query == q.id
    assert by["plan"].parent == q.id
    assert by["lease_hold"].parent == q.id
    assert by["fetch"].parent == by["lease_hold"].id
    assert by["pin"].parent == by["fetch"].id
    assert by["finish"].parent == q.id
    assert by["finish"].t1_ns == by["query"].t1_ns
    assert by["fetch"].attrs == {"bytes": 24}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        assert s.thread == threading.get_native_id()
    assert q2.query == q2.id != q.id
    assert [s for s in spans if s.query == q2.id] == [q2]


def test_a_span_that_raises_carries_the_error(recorder):
    with pytest.raises(KeyError):
        with M.span("query"):
            with M.span("plan"):
                raise KeyError("x")
    spans = {s.name: s for s in M.stop_spans()}
    assert spans["query"].attrs["error"] == "KeyError"
    assert spans["plan"].attrs["error"] == "KeyError"


@pytest.mark.parametrize("threads,rounds", [(8, 1), (32, 20)])
def test_concurrent_queries_keep_their_spans_apart(recorder, threads,
                                                    rounds):
    """8 streams' queries at once, and more threads than cores switching
    every microsecond: no span is lost, each id is one span's, and each
    query's spans stay on its thread under its root."""
    barrier = threading.Barrier(threads)
    ids = {}

    def stream(i):
        barrier.wait()
        for r in range(rounds):
            with M.span("query") as q:
                ids[i, r] = (q.id, threading.get_native_id())
                for step in ("plan", "decide", "finish"):
                    with M.span(step):
                        if rounds == 1:
                            time.sleep(0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=stream, args=(i,))
                   for i in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers)
    spans = M.stop_spans()
    assert len(spans) == threads * rounds * 4
    assert len({s.id for s in spans}) == len(spans)
    assert len({qid for qid, _ in ids.values()}) == threads * rounds
    for qid, thread in ids.values():
        mine = [s for s in spans if s.query == qid]
        assert sorted(s.name for s in mine) == ["decide", "finish", "plan",
                                                "query"]
        assert {s.thread for s in mine} == {thread}
        assert all(s.parent == qid for s in mine if s.id != qid)


def test_a_profiler_session_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    M.stop_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        assert M.spans_on()
        with M.span("query"):
            pass
    assert not M.spans_on()
    assert [s.name for s in M.stop_spans()] == ["query"]


def test_fetch_counts_the_bytes_it_hands_back(recorder):
    tensors = [torch.arange(7, dtype=torch.int64),
               torch.ones(3, dtype=torch.bool),
               torch.zeros((2, 5), dtype=torch.float32)]
    arrays = D.to_host(tensors)
    (fetch,) = M.stop_spans()
    assert fetch.name == "fetch"
    assert fetch.attrs["bytes"] == sum(a.nbytes for a in arrays) == 56 + 3 + 40


def _tiny_tables(rows=4000, seed=3):
    rng = np.random.default_rng(seed)
    orders = np.arange(1, rows // 4 + 1, dtype=np.int64)
    return {"orders": {"orderkey": orders,
                       "o_orderdate": rng.integers(0, 100, len(orders))
                       .astype(np.int32)},
            "lineitem": {"orderkey": rng.choice(orders, rows),
                         "l_shipdate": rng.integers(0, 100, rows)
                         .astype(np.int32),
                         "l_extendedprice": rng.integers(1, 10**6, rows)
                         .astype(np.int64)}}


def _tiny_queries(session):
    from repro_torch.core import col

    core = (session.table("lineitem").join("orders", on="orderkey")
            .filter((col("b_o_orderdate") < 50) & (col("l_shipdate") > 50))
            .sort("b_o_orderdate", "orderkey"))
    return {"scalar": core.aggregate("l_extendedprice", "sum"),
            "rows": core.select("orderkey", "b_o_orderdate",
                                "l_extendedprice")}


def test_a_fused_query_leaves_every_step():
    server = QueryServer(_tiny_tables(), device="cpu", policy="tensor",
                         work_mem=1 << 20, total_mem=64 << 20)
    queries = _tiny_queries(server.session)
    for q in queries.values():      # cold: the programs are built
        server.submit(q)
    for name, q in queries.items():
        M.start_spans()
        try:
            res = server.submit(q)
        finally:
            spans = M.stop_spans()
        assert [m.op for m in res.metrics] == ["fused_pipeline"]
        assert FUSED_STEPS <= {s.name for s in spans}
        (root,) = [s for s in spans if s.parent is None]
        assert root.name == "query" and "error" not in root.attrs
        assert {s.query for s in spans} == {root.id}
        by = _tree(spans)
        kids = {s.name for s in spans if s.parent == root.id}
        assert kids == {"plan", "decide", "prepare", "lease_wait",
                        "lease_hold", "finish"}
        for s in spans:
            if s.name in ("launch", "fetch"):
                assert by[s.parent].name == "lease_hold"
            assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns
        (decide,) = [s for s in spans if s.name == "decide"]
        assert decide.attrs["path"] == "tensor"
        (launch,) = [s for s in spans if s.name == "launch"]
        assert launch.attrs["fresh"] == 0
        (hold,) = [s for s in spans if s.name == "lease_hold"]
        assert hold.attrs["group"] == 1
        (prepare,) = [s for s in spans if s.name == "prepare"]
        assert prepare.attrs["h2d_bytes"] == 0        # warm: nothing uploads
        (finish,) = [s for s in spans if s.name == "finish"]
        (fetch,) = [s for s in spans if s.name == "fetch"]
        if name == "rows":
            assert finish.attrs["rows_out"] == len(res.relation)
            # the whole capacity comes back: the three columns and the mask
            assert fetch.attrs["bytes"] > res.relation.row_bytes() * len(
                res.relation)
        else:
            assert finish.attrs["rows_out"] == 1


def test_the_sharded_fragment_launches_a_block_per_card(recorder):
    """The sharded deployment's configuration (its cell kept under
    ``portbench/``) at a tiny size on four CPU stand-ins for its cards:
    each block's launch is its own span, with its card."""
    from portbench import harness, tiny

    cell = "tpch10-q3sum-8part-4cards"
    cfg = tiny.config(cell, policy="tensor")
    cards = ("cpu",) * cfg["cards"]
    tables = harness.host_tables(
        harness.data_module(cfg["data"]).make_tables(cfg, 2**31 + 5, "cpu"))
    server = QueryServer(dict(tables), device=cards,
                         **{k: cfg[k] for k in harness.SERVER_OPTIONS
                            if k in cfg})
    traffic = harness.traffic_of(
        harness.cell_of(tiny.bench(), cell)[0]["traffic"])
    q = harness.query_module("qa").build(server.session, traffic["params"])
    (stage,) = plan_program(q.logical()).stages
    spec, build, probe = fused.match_fragment(stage.build_physical([]))
    M.stop_spans()
    fused.run_fused(spec, build, probe, shards=cfg["max_shards"],
                    device=cards)
    M.start_spans()
    _, m = fused.run_fused(spec, build, probe, shards=cfg["max_shards"],
                           device=cards)
    spans = M.stop_spans()
    assert m.devices == cfg["max_shards"]
    launches = [s for s in spans if s.name == "launch"]
    assert sorted(s.attrs["card"] for s in launches) == list(range(len(cards)))
    (hold,) = [s for s in spans if s.name == "lease_hold"]
    assert hold.attrs == {"group": 1, "lanes": cfg["max_shards"]}
    assert all(s.parent == hold.id for s in launches)
    assert [s.name for s in spans].count("lease_wait") == 1


def test_a_lease_counts_its_group_joiners_included(recorder):
    queue = DeviceQueue()
    first = queue.acquire(batch_key="k")       # runs alone
    joined = threading.Event()
    done = threading.Event()

    def joiner():
        lease = queue.acquire(batch_key="k")    # joins the running round
        joined.set()
        done.wait(5)
        lease.release()

    t = threading.Thread(target=joiner)
    t.start()
    assert joined.wait(5)
    first.release()
    done.set()
    t.join(10)
    assert not t.is_alive()
    spans = M.stop_spans()
    holds = [s for s in spans if s.name == "lease_hold"]
    waits = [s for s in spans if s.name == "lease_wait"]
    assert [s.attrs["group"] for s in holds] == [2, 2]
    assert sorted(s.attrs["depth"] for s in waits) == [0, 1]
    # each lease's spans sit on the thread that acquired it
    assert len({s.thread for s in holds}) == 2
