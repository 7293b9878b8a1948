"""The port's concurrent serving layer against the reference on the CPU.

``repro_torch.core.QueryServer(device="cpu")`` and ``repro.core.QueryServer``
serve the same small star-join tables (the fixtures of
``tests/test_server.py`` and ``tests/test_serving_open.py``), handed across
as numpy.  Every served answer equals a serial run of the reference bit for
bit (int64 sums and sorted relations), the served/shed/failed partitions
equal the reference server's, the governor never over-grants, and a
preempted linear operator re-runs on the tensor path.  The workload adds a
per-operator device ORDER BY, which goes through the multi-key sort.
"""
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import device as D  # noqa: E402
from test_server import star_tables  # noqa: E402

MB = 1 << 20


def _tables(M, **kw):
    cols = {name: rel.columns for name, rel in star_tables(**kw).items()}
    return {name: M.Relation({c: np.array(v) for c, v in cs.items()})
            for name, cs in cols.items()}


def _workload(sess, M):
    """tests/test_server.py's mixed stream plus a filtered ORDER BY."""
    col = M.col
    return [
        (sess.table("orders").join("users", on="uid")
         .filter((col("w") > 0) & (col("b_region") <= 2))
         .sort("uid").aggregate("w", "sum")),
        (sess.table("orders").join("users", on="uid")
         .join("parts", on="pid").filter(col("w") != 0)
         .aggregate("w", "count")),
        (sess.table("orders").join("parts", on="pid")
         .filter(col("b_price") >= 3).sort("pid", "w")
         .select("pid", "w", "b_price")),
        (sess.table("orders").join("users", on="uid")
         .group_by("b_region", {"w": "sum"})),
        (sess.table("orders").filter(col("w") > 30).sort("pid", "uid")
         .select("uid", "pid", "w")),
    ]


_N = 20_000


@pytest.fixture(scope="module")
def serial_results():
    """Ground truth: the workload through an ungoverned, single-thread
    reference session."""
    sess = R.Session(work_mem=64 * MB, policy="auto")
    for name, rel in _tables(R, n_orders=_N).items():
        sess.register(name, rel)
    return [(r.scalar, r.relation)
            for r in (q.collect() for q in _workload(sess, R))]


def _assert_matches_serial(record, serial_results):
    want_scalar, want_rel = serial_results[record.workload_idx]
    if want_scalar is not None:
        assert record.scalar == want_scalar
    else:
        got = record.relation
        assert got is not None
        if record.workload_idx == 4:  # ORDER BY pid, uid: the order itself
            for k in want_rel.names:
                np.testing.assert_array_equal(got[k], want_rel[k])
        else:
            assert set(got.names) == set(want_rel.names)
            a, b = got.sort_canonical(), want_rel.sort_canonical()
            for k in want_rel.names:
                np.testing.assert_array_equal(a[k], b[k])


def _server(M, policy, total_mem=8 * MB):
    kw = {"device": "cpu"} if M is T else {}
    return M.QueryServer(_tables(M, n_orders=_N), total_mem=total_mem,
                         work_mem=4 * MB, policy=policy, min_grant=1 * MB,
                         **kw)


@pytest.mark.parametrize("policy", ["linear", "tensor", "auto"])
def test_closed_loop_matches_serial_and_reference(policy, serial_results):
    """Concurrency and memory pressure may change paths; they must never
    change answers, and both servers serve every query."""
    D.reset_launch_counts()
    reports = {}
    for M in (T, R):
        server = _server(M, policy)
        rep = server.serve(_workload(server.session, M), concurrency=4,
                           queries_per_worker=5, warmup=1)
        for record in rep.queries:
            _assert_matches_serial(record, serial_results)
        assert rep.governor.over_budget_events == 0
        assert rep.governor.peak_in_use <= server.governor.total_bytes
        reports[M] = rep
    assert reports[T].counts == reports[R].counts == {
        "submitted": 20, "served": 20, "shed": 0, "failed": 0}
    if policy != "auto":
        assert {q.paths for q in reports[T].queries} == {policy}
    # CPU tensors take the plain versions: no kernel launches
    assert not any(D.launch_counts().values())


def test_governor_never_overgrants_under_load():
    work_mem = 4 * MB
    server = T.QueryServer(_tables(T, n_orders=_N), total_mem=6 * MB,
                           work_mem=work_mem, policy="linear",
                           min_grant=1 * MB, device="cpu")
    workload = _workload(server.session, T)
    results, errors = [], []

    def worker():
        try:
            for q in workload:
                results.append(server.submit(q))
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(results) == 5 * len(workload)
    stats = server.governor.stats()
    assert stats.over_budget_events == 0
    assert stats.peak_in_use <= 6 * MB
    assert server.governor.in_use == 0
    for res in results:
        for m in res.metrics:
            if m.grant_bytes:
                assert m.grant_bytes <= work_mem
            assert not (m.spill.bytes_written and not m.grant_bytes)


def test_open_loop_light_load_serves_everything(serial_results):
    reports = {}
    for M in (T, R):
        server = _server(M, "auto", total_mem=64 * MB)
        wl = _workload(server.session, M)
        rep = server.serve_open(
            workloads={"prem": wl[:2], "be": wl[2:]},
            arrivals={"prem": M.ArrivalProcess(rate_qps=12, seed=1),
                      "be": M.ArrivalProcess(rate_qps=12, seed=2)},
            duration_s=1.0, workers=3,
            tenants=[M.TenantClass("prem", deadline_s=10.0, priority=2,
                                   sheddable=False),
                     M.TenantClass("be", deadline_s=10.0)])
        assert server.governor.held_bytes == 0
        assert rep.governor.over_budget_events == 0
        for r in rep.queries:
            idx = r.workload_idx + (0 if r.tenant == "prem" else 2)
            want_scalar, _ = serial_results[idx]
            if want_scalar is not None:
                assert r.scalar == want_scalar
            assert r.wall_s >= r.service_s > 0 and r.slo_ok
        reports[M] = rep
    tp, rp = reports[T], reports[R]
    assert tp.counts == rp.counts
    assert tp.counts["served"] == tp.counts["submitted"] > 10
    for tenant in ("prem", "be"):
        assert tp.tenant_counts(tenant) == rp.tenant_counts(tenant)
        assert tp.slo_attainment(tenant) == 1.0


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_failures_become_samples_like_the_reference(loop, serial_results):
    """An item that raises becomes a FailedQuery and the run keeps going;
    the partitions and error types equal the reference server's."""
    out = {}
    for M in (T, R):
        server = _server(M, "auto", total_mem=64 * MB)
        wl = [_workload(server.session, M)[1], object()]
        if loop == "closed":
            rep = server.serve(wl, concurrency=2, queries_per_worker=4,
                               warmup=0)
        else:
            rep = server.serve_open(
                workloads={"t": wl},
                arrivals={"t": M.ArrivalProcess(rate_qps=20, seed=6)},
                duration_s=0.6,
                tenants=[M.TenantClass("t", deadline_s=10.0)], workers=2,
                warmup=0)
        for r in rep.queries:
            assert r.workload_idx == 0 and r.scalar == serial_results[1][0]
        out[M] = (rep.counts, sorted({f.error for f in rep.failed}),
                  sorted(f.workload_idx for f in rep.failed))
    assert out[T] == out[R]
    counts = out[T][0]
    assert counts["failed"] > 0 and counts["served"] > 0
    assert counts["submitted"] == counts["served"] + counts["failed"]


def test_preemption_reruns_degraded_linear_join_on_tensor_path():
    n = 100_000
    rng = np.random.default_rng(1)
    cols = {"b": {"k": rng.permutation(n).astype(np.int64),
                  "v": rng.integers(0, 1 << 30, n).astype(np.int64)},
            "p": {"k": rng.integers(0, n, n).astype(np.int64),
                  "w": rng.integers(0, 1000, n).astype(np.int64)}}
    ref = R.Session(work_mem=256 * MB)
    for name, c in cols.items():
        ref.register(name, R.Relation(dict(c)))
    want = ref.table("p").join("b", on="k").aggregate("b_v", "sum").scalar()

    server = T.QueryServer(T.tables_from_numpy(cols), total_mem=1 * MB,
                           work_mem=64 * MB, policy="linear",
                           min_grant=256 * 1024, device="cpu")
    preempted = threading.Event()

    def watcher():
        deadline = time.time() + 30
        while time.time() < deadline and not preempted.is_set():
            if server.broker.preempt_degraded() > 0:
                preempted.set()
                return
            time.sleep(0.001)

    th = threading.Thread(target=watcher, daemon=True)
    th.start()
    # the 1.6 MB hash build against a 1 MB pool degrades to the floor and
    # polls its preempt token in the grace-join spill regime
    res = server.submit(server.session.table("p").join("b", on="k")
                        .aggregate("b_v", "sum"))
    preempted.set()
    th.join(timeout=5)
    assert not th.is_alive()
    assert res.scalar == want
    assert any(m.preempted and m.path == "tensor" for m in res.metrics)
    s = server.broker.stats()
    assert s.preemptions >= 1 and s.preempt_registered >= 1
    gov = server.governor
    assert gov.stats().over_budget_events == 0
    assert gov.in_use == 0 and gov.held_bytes == 0


def test_server_device_and_shards(monkeypatch):
    tables = {"t": {"a": np.arange(3, dtype=np.int64)}}
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        T.QueryServer(tables, total_mem=None, max_shards=2, device="cpu")
    sess = T.Session(work_mem=4 * MB, device="cpu")
    with pytest.raises(ValueError):
        T.QueryServer({}, total_mem=None, session=sess, device="cpu")
    assert T.QueryServer(tables, total_mem=None,
                         device="cpu").session.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.QueryServer(tables, total_mem=8 * MB)


def test_launch_counters_lose_no_increment_across_threads():
    """Serving threads count launches concurrently: 16 threads, a switch
    interval of a microsecond, and the total must still be exact."""
    D.reset_launch_counts()
    per, threads_n = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [D.count_launch("radix_sort_pass")
                            for _ in range(per)]) for _ in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert D.launch_counts()["radix_sort_pass"] == per * threads_n
    D.reset_launch_counts()
    assert not any(D.launch_counts().values())
