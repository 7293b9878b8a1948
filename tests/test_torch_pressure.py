"""The port's memory-pressure path against the reference on the CPU.

``repro_torch.core`` (``device="cpu"``) and ``repro.core`` in one process,
on the setups and sizes of the reference's own tests: the tiered spill
hierarchy (``tests/test_tiers.py``: a tiered session equals a plain one,
each tier's byte books equal the reference's for the same query, and
``verify_balanced()`` passes), the fault injector and retry policy
(``tests/test_faults.py``: the same schedule and backoff from the same
seed), the spill manager's reader and writer (``tests/test_spill.py``),
and open-loop serving under a storm and under chaos
(``tests/test_serving_open.py``: every query served, shed or failed,
never over budget, every served answer the reference's serial one bit for
bit, crash-consistent spill writes).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.metrics import SpillAccount as RSpillAccount  # noqa: E402
from repro_torch.core.metrics import SpillAccount  # noqa: E402
from test_serving_open import serial_scalars  # noqa: E402
from test_serving_open import star_tables as open_tables  # noqa: E402
from test_tiers import _star_tables  # noqa: E402

MB = 1 << 20
TIERS = ("t0", "t1", "t2")


def _port(*rels):
    out = tuple(T.Relation({k: np.array(v) for k, v in r.columns.items()})
                for r in rels)
    return out if len(out) > 1 else out[0]


def _fast_tiers(M, **kw):
    """``test_tiers._fast_tiers`` for engine module ``M``: an emulated
    remote tier that is effectively free."""
    kw.setdefault("t1_latency_s", 0.0)
    kw.setdefault("t1_gbps", 1000.0)
    return M.TierConfig(**kw)


def _books(sess):
    """Each tier's byte books of a session's ledger."""
    snap = sess.tier_ledger.snapshot()
    return {t: {k: snap[t][k] for k in ("bytes_written", "bytes_read",
                                         "bytes_freed", "live_bytes")}
            for t in TIERS}


# ---------------------------------------------------------------------------
# The tiered spill hierarchy
# ---------------------------------------------------------------------------

def _tiered_join(M, fact, dim, **extra):
    kw = dict(work_mem=1 * MB, policy="linear", fuse=False)
    if M is T:
        kw["device"] = "cpu"
    s = M.Session(**kw, **extra)
    s.register("fact", fact).register("dim", dim)
    q = (s.table("fact").join("dim", on="k").sort("k", "w")
         .aggregate("b_v", "sum"))
    return s, q.collect()


def test_tiered_session_equals_plain_session():
    fact, dim = _star_tables()
    pf, pd = _port(fact, dim)
    _, ref_plain = _tiered_join(R, fact, dim)
    ref_s, ref_tier = _tiered_join(
        R, fact, dim, tiers=_fast_tiers(R, t0_capacity=2 * MB,
                                        t1_capacity=8 * MB))
    _, plain = _tiered_join(T, pf, pd)
    s_tier, tiered = _tiered_join(
        T, pf, pd, tiers=_fast_tiers(T, t0_capacity=2 * MB,
                                     t1_capacity=8 * MB))
    assert plain.scalar == pytest.approx(ref_plain.scalar)
    assert tiered.scalar == pytest.approx(plain.scalar)
    assert tiered.scalar == pytest.approx(ref_tier.scalar)
    assert any(m.spill.bytes_written > 0 for m in tiered.metrics)
    books = _books(s_tier)
    assert sum(books[t]["bytes_written"] for t in TIERS) > 0
    assert books == _books(ref_s)
    assert ([(m.op, m.path, m.spill.bytes_written) for m in tiered.metrics]
            == [(m.op, m.path, m.spill.bytes_written)
                for m in ref_tier.metrics])
    s_tier.tier_ledger.verify_balanced()


def _tiered_sort(M, fact, **extra):
    kw = dict(work_mem=256 * 1024, policy="linear", fuse=False)
    if M is T:
        kw["device"] = "cpu"
    s = M.Session(**kw, **extra)
    s.register("fact", fact)
    return s, s.table("fact").sort("k", "w").collect()


def test_tiered_sort_spill_matches_plain():
    fact, _ = _star_tables(40_000)
    pf = _port(fact)
    _, ref_plain = _tiered_sort(R, fact)
    ref_s, _ = _tiered_sort(R, fact, tiers=_fast_tiers(R, t0_capacity=1 * MB))
    _, plain = _tiered_sort(T, pf)
    s_tier, tiered = _tiered_sort(T, pf,
                                  tiers=_fast_tiers(T, t0_capacity=1 * MB))
    for res in (plain, tiered):  # the rows in the reference's order
        for name in ref_plain.relation.names:
            np.testing.assert_array_equal(res.relation[name],
                                          ref_plain.relation[name])
    books = _books(s_tier)
    assert sum(books[t]["bytes_written"] for t in TIERS) > 0
    assert books == _books(ref_s)
    s_tier.tier_ledger.verify_balanced()


@pytest.mark.slow
@pytest.mark.parametrize("t0_mb", [0, 2, 16])
@pytest.mark.parametrize("budget_mb", [6, 24])
def test_tier_sweep_balances_under_concurrency(t0_mb, budget_mb):
    fact, dim = _star_tables(120_000)
    ref = R.Session(work_mem=64 * MB, policy="linear", fuse=False)
    ref.register("fact", fact).register("dim", dim)
    want = (ref.table("fact").join("dim", on="k").sort("k", "w")
            .aggregate("b_v", "sum").scalar())
    pf, pd = _port(fact, dim)
    srv = T.QueryServer(
        {"fact": pf, "dim": pd}, total_mem=budget_mb * MB,
        work_mem=8 * MB, min_grant=1 * MB, policy="linear", device="cpu",
        tiers=_fast_tiers(T, t0_capacity=t0_mb * MB, t1_capacity=64 * MB))
    q = (srv.session.table("fact").join("dim", on="k").sort("k", "w")
         .aggregate("b_v", "sum"))
    rep = srv.serve([q], concurrency=4, queries_per_worker=3)
    assert rep.counts["failed"] == 0
    assert rep.governor.over_budget_events == 0
    for sq in rep.queries:
        assert sq.scalar == pytest.approx(want)
    srv.session.tier_ledger.verify_balanced()


# ---------------------------------------------------------------------------
# Fault injector and retry policy: the reference's schedules
# ---------------------------------------------------------------------------

def _schedule(M, seed, n=100, **probs):
    """Which of ``n`` rounds of every fault site fired, per site, for an
    injector of engine module ``M`` (sleeps stubbed out)."""
    inj = M.FaultInjector(seed=seed, device_slow_s=0.0, remote_slow_s=0.0,
                          **probs)
    sites = (("spill_io", lambda i: inj.on_spill_column(str(i))),
             ("device", lambda i: inj.on_device_dispatch()),
             ("grant", lambda i: inj.on_memory_grant()),
             ("spill_read", lambda i: inj.on_spill_read(str(i))),
             ("remote", lambda i: inj.on_remote_read(1)))
    fired = {name: [] for name, _ in sites}
    for i in range(n):
        for name, call in sites:
            try:
                call(i)
                fired[name].append(False)
            except M.TransientError:
                fired[name].append(True)
    return fired, inj.counts()


@pytest.mark.parametrize("seed,probs", [
    (5, dict(spill_io_p=0.3)),
    (6, dict(spill_io_p=0.3)),
    (9, dict(spill_io_p=0.3, device_fail_p=0.5)),
    (3, dict(spill_io_p=0.01, device_fail_p=0.02, device_slow_p=0.03,
             grant_timeout_p=0.01)),          # the open-loop hammer's
    (7, dict(spill_io_p=0.01, device_slow_p=0.05, grant_timeout_p=0.01,
             spill_read_p=0.01)),             # the chaos switch hammer's
    (0, dict(spill_io_p=1.0, device_fail_p=1.0, grant_timeout_p=1.0,
             spill_read_p=1.0, remote_slow_p=1.0)),
])
def test_injector_schedule_equals_reference(seed, probs):
    port = _schedule(T, seed, **probs)
    assert port == _schedule(R, seed, **probs)
    if any(p > 0.05 for p in probs.values()):
        assert any(any(f) for f in port[0].values())


def test_injector_kill_and_validation_as_in_reference():
    for M in (R, T):
        inj = M.FaultInjector(seed=0)
        inj.arm_spill_kill(after_columns=3)
        inj.on_spill_column("a")
        inj.on_spill_column("b")
        with pytest.raises(M.SimulatedCrash):
            inj.on_spill_column("c")
        for i in range(10):
            inj.on_spill_column(str(i))
        assert inj.counts()["spill_kill"] == 1
        with pytest.raises(ValueError):
            inj.arm_spill_kill(after_columns=0)
        for bad in (dict(spill_io_p=1.5), dict(device_fail_p=-0.1)):
            with pytest.raises(ValueError):
                M.FaultInjector(**bad)
    assert issubclass(T.SimulatedCrash, BaseException)
    assert not issubclass(T.SimulatedCrash, Exception)
    for exc in (T.SpillIOError, T.DeviceDispatchError, T.GrantTimeout):
        assert issubclass(exc, T.TransientError)
    assert issubclass(T.GrantTimeout, TimeoutError)
    assert issubclass(T.SpillIOError, OSError)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_retry_policy_envelope_equals_reference(seed):
    kw = dict(max_attempts=5, base_s=0.01, cap_s=0.05, seed=seed)
    port, ref = T.RetryPolicy(**kw), R.RetryPolicy(**kw)
    assert port.device_fallback_after == ref.device_fallback_after
    assert port.max_attempts == ref.max_attempts
    for attempt in range(1, 10):
        ceiling = min(0.05, 0.01 * 2 ** (attempt - 1))
        for _ in range(20):
            d = port.backoff(attempt)
            assert d == ref.backoff(attempt)
            assert 0.0 <= d <= ceiling
    with pytest.raises(ValueError):
        T.RetryPolicy(max_attempts=0)


# ---------------------------------------------------------------------------
# The spill manager's reader and writer
# ---------------------------------------------------------------------------

def test_run_reader_on_empty_dir_raises_value_error_not_stopiteration():
    with T.SpillManager() as mgr:
        empty = os.path.join(mgr.dir, "empty_run")
        os.makedirs(empty)
        with pytest.raises(ValueError, match="no column files"):
            mgr.open_run_reader(empty, SpillAccount())

        def gen():
            yield mgr.open_run_reader(empty, SpillAccount())

        with pytest.raises(ValueError):
            next(gen())


def _read_chunks(mgr, path, acct, rows=33):
    reader = mgr.open_run_reader(path, acct)
    chunks = []
    while not reader.exhausted:
        chunks.append(reader.read_rows(rows))
    out = chunks[0]
    for c in chunks[1:]:
        out = out.concat(c)
    return out


def test_run_reader_roundtrip_equals_reference():
    cols = {"a": np.arange(100, dtype=np.int64),
            "b": np.arange(100, dtype=np.int64) * 3}
    with T.SpillManager() as mgr, R.SpillManager() as rmgr:
        acct, racct = SpillAccount(), RSpillAccount()
        out = _read_chunks(mgr, mgr.write_relation(T.Relation(cols), "run",
                                                   acct), acct)
        rout = _read_chunks(rmgr, rmgr.write_relation(R.Relation(cols), "run",
                                                      racct), racct)
        assert out.equals(T.Relation(cols))
        for name in cols:
            np.testing.assert_array_equal(out[name], rout[name])
        assert ((acct.bytes_written, acct.bytes_read, acct.files_created)
                == (racct.bytes_written, racct.bytes_read,
                    racct.files_created))


def test_write_relation_failure_removes_partial_dir(monkeypatch):
    rel = T.Relation({c: np.arange(64, dtype=np.int64) for c in "abc"})
    with T.SpillManager() as mgr:
        acct = SpillAccount()
        real_save = np.save
        calls = {"n": 0}

        def failing_save(path, arr, **kw):
            calls["n"] += 1
            if calls["n"] == 2:  # first column lands, second write dies
                raise OSError("disk full")
            return real_save(path, arr, **kw)

        monkeypatch.setattr(np, "save", failing_save)
        with pytest.raises(OSError, match="disk full"):
            mgr.write_relation(rel, "jb", acct)
        monkeypatch.setattr(np, "save", real_save)
        assert calls["n"] == 2
        assert os.listdir(mgr.dir) == []
        assert acct.files_created == 0
        path = mgr.write_relation(rel, "jb", acct)
        assert mgr.read_relation(path, SpillAccount()).equals(rel)


def test_spill_write_is_atomic_under_midwrite_crash(tmp_path):
    inj = T.FaultInjector(seed=0)
    mgr = T.SpillManager(root=str(tmp_path), faults=inj)
    rel = T.Relation({"a": np.arange(100), "b": np.arange(100) * 2,
                      "c": np.arange(100) * 3})
    acct = SpillAccount()
    inj.arm_spill_kill(after_columns=2)
    with pytest.raises(T.SimulatedCrash):
        mgr.write_relation(rel, "run", acct)
    entries = sorted(os.listdir(mgr.dir))
    assert entries and all(e.endswith(".tmp") for e in entries)
    assert acct.files_created == 0
    base = mgr.write_relation(rel, "run", SpillAccount())
    got = mgr.read_relation(base, SpillAccount())
    for name in rel.columns:
        assert np.array_equal(got[name], rel[name])
    mgr.cleanup()


def test_spill_write_cleans_tmp_on_ordinary_failure(tmp_path):
    inj = T.FaultInjector(seed=0, spill_io_p=1.0)
    mgr = T.SpillManager(root=str(tmp_path), faults=inj)
    with pytest.raises(OSError):
        mgr.write_relation(T.Relation({"a": np.arange(10)}), "run",
                           SpillAccount())
    assert os.listdir(mgr.dir) == []
    mgr.cleanup()


# ---------------------------------------------------------------------------
# Open-loop serving under a storm and under chaos
# ---------------------------------------------------------------------------

def _server(n, faults=None, total_mem=64 * MB, **kw):
    """``test_serving_open.make_server`` on the port: the aggregate and
    the sorted aggregate over the star join."""
    build, probe = _port(*open_tables(n))
    server = T.QueryServer({"b": build, "p": probe}, total_mem=total_mem,
                           work_mem=kw.pop("work_mem", 16 * MB),
                           faults=faults, device="cpu", **kw)
    s = server.session
    q_agg = s.table("p").join("b", on="k").aggregate("b_v", "sum")
    q_sort = (s.table("p").join("b", on="k").sort("k", "w")
              .aggregate("b_v", "sum"))
    return server, q_agg, q_sort


def test_open_loop_sheds_under_storm_but_does_not_starve():
    ref = serial_scalars(60_000)
    server, _, q_sort = _server(60_000)
    be = T.TenantClass("be", deadline_s=0.06)
    rep = server.serve_open(
        workloads={"be": [q_sort]},
        arrivals={"be": T.ArrivalProcess(
            phases=[(0.25, 20), (0.5, 500), (0.5, 20)], seed=2)},
        duration_s=1.25, tenants=[be], workers=2, warmup=1)
    c = rep.counts
    assert c["submitted"] == c["served"] + c["shed"] + c["failed"]
    assert c["shed"] > 0, f"storm never shed: {c}"
    assert c["served"] > 0, f"tenant starved: {c}"
    for s in rep.shed:
        assert s.quoted_wait_s > s.deadline_s == 0.06
    for f in rep.failed:
        assert f.error == "DeadlineExceeded"
    for r in rep.queries:
        assert r.scalar == ref[1]
    assert rep.governor.over_budget_events == 0


def test_hammer_storm_chaos_invariants():
    """``test_serving_open._hammer`` (1.4 s, a 250 q/s storm) on the port,
    with ``check_hammer_invariants``' gates against the reference's
    serial answers."""
    n = 60_000
    ref = serial_scalars(n)
    inj = T.FaultInjector(seed=3, spill_io_p=0.01, device_fail_p=0.02,
                          device_slow_p=0.03, device_slow_s=0.002,
                          grant_timeout_p=0.01)
    server, q_agg, q_sort = _server(n, inj, total_mem=12 * MB,
                                    work_mem=8 * MB, min_grant=1 * MB,
                                    full_grant_wait_s=0.01)
    prem = T.TenantClass("prem", deadline_s=5.0, priority=2, sheddable=False)
    be = T.TenantClass("be", deadline_s=0.08)
    duration_s = 1.4
    rep = server.serve_open(
        workloads={"prem": [q_agg, q_sort], "be": [q_sort, q_agg]},
        arrivals={"prem": T.ArrivalProcess(rate_qps=10, seed=7),
                  "be": T.ArrivalProcess(
                      phases=[(0.3, 20), (duration_s - 0.6, 250),
                              (0.3, 20)], seed=8)},
        duration_s=duration_s, tenants=[prem, be], workers=3, warmup=1)
    c = rep.counts
    assert c["submitted"] == c["served"] + c["shed"] + c["failed"]
    g = server.governor.stats()
    assert g.over_budget_events == 0
    assert g.peak_in_use <= server.governor.total_bytes
    assert g.holds == (g.holds_converted + g.holds_expired
                       + g.holds_cancelled)
    assert server.governor.held_bytes == 0
    assert server.governor.in_use == 0
    for r in rep.queries:
        assert r.scalar == ref[r.workload_idx]
    assert rep.tenant_counts("prem")["shed"] == 0
    for f in rep.failed:
        assert f.error
    assert c["shed"] > 0
