"""The port's execution-time guards against the reference on the CPU.

``repro_torch.core`` (``device="cpu"``: the plain versions of the kernels)
and ``repro.core`` run the cases of ``tests/test_adaptive_guards.py`` side
by side in one process: the ``ExecutionGuard`` unit cases give the same
checkpoints, firings and switch points; a stale-priced ``auto`` session
(fig14's mis-calibration: linear priced 50x too cheap) that spills is
taken over by the tensor path loss-free, with the answer of the
reference's linear run bit for bit and balanced spill books; and the chaos
hammer (an 8-worker governed serve with injected faults, tiers and eager
hysteresis) keeps its ledger invariants.  Where a guard fires depends on
wall time, so switches under tiers or concurrency are counted, never
required.  A kernel error during a takeover propagates: the query raises,
it does not finish on the linear path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.cost_model import CostModel as RCostModel  # noqa: E402
from repro.core.guards import ExecutionGuard as RGuard  # noqa: E402
from repro.core.guards import SwitchPoint as RSwitchPoint  # noqa: E402
from repro_torch.core.cost_model import CostModel as TCostModel  # noqa: E402
from repro_torch.core.guards import ExecutionGuard as TGuard  # noqa: E402
from repro_torch.core.guards import SwitchPoint as TSwitchPoint  # noqa: E402
from test_adaptive_guards import STALE, star_tables  # noqa: E402

MB = 1 << 20

#: (guard class, cost model class, switch point class) of each package
ENGINES = {"reference": (RGuard, RCostModel, RSwitchPoint),
           "port": (TGuard, TCostModel, TSwitchPoint)}


def _port(*rels):
    """The reference's relations as the port's (numpy columns handed
    across)."""
    out = tuple(T.Relation({k: np.array(v) for k, v in r.columns.items()})
                for r in rels)
    return out if len(out) > 1 else out[0]


def _session(M, **kw):
    """A session of engine module ``M``; the port's runs on the CPU."""
    if M is T:
        kw.setdefault("device", "cpu")
    return M.Session(**kw)


def _stale(M, wm=256 * 1024, guards=True, **kw):
    """``test_adaptive_guards.stale_session`` for engine module ``M``."""
    s = _session(M, work_mem=wm, policy="auto", guards=guards, **kw)
    s.selector.model.c.linear_row_cost *= STALE
    s.selector.model.c.io_byte_cost *= STALE
    return s


def _join(s, build, probe):
    s.register("b", build).register("p", probe)
    return (s.table("p").join("b", on="k").aggregate("b_v", "sum")).collect()


def _switched(res):
    return [m for m in res.metrics if m.switched]


@pytest.fixture
def probe_calls(monkeypatch):
    """The domains of the join kernels' table build and probe
    (``radix_hash_probe_dispatch``: on the card ``radix_rank``,
    ``join_table_build``, ``join_table_probe``) called during the test."""
    import repro_torch.core.fused as F

    calls = []
    real = F.radix_hash_probe_dispatch

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(F, "radix_hash_probe_dispatch", spy)
    return calls


@pytest.fixture(scope="module")
def star120():
    """The 120,000-row star tables and the reference's linear answer at
    64 MB (no spill)."""
    build, probe = star_tables(120_000)
    want = _join(R.Session(work_mem=64 * MB, policy="linear"), build, probe)
    return build, probe, want.scalar


# ---------------------------------------------------------------------------
# ExecutionGuard: unit cases, both packages on the same inputs
# ---------------------------------------------------------------------------

class _Spill:
    def __init__(self, written=0, live=0):
        self.bytes_written = written
        self.live_bytes = live


def _guard(engine, **kw):
    Guard, Model, _ = ENGINES[engine]
    kw.setdefault("op", "hash_join")
    kw.setdefault("t_linear", 1e-6)   # everything drifts immediately
    kw.setdefault("t_tensor", 1e-3)
    kw.setdefault("predicted_spill_bytes", 0)
    kw.setdefault("rows_in", 1 << 20)
    return Guard(Model(), **kw)


def _trace(engine, calls, **kw):
    """Run ``calls`` (``(method, kwargs)``, in order) against one guard of
    ``engine``: the checkpoints, whether it fired, and each switch point's
    (op, restart, pending) or None."""
    g = _guard(engine, **kw)
    _, _, Switch = ENGINES[engine]
    out = []
    for name, args in calls:
        try:
            getattr(g, name)(**args)
            out.append(None)
        except Switch as sp:
            out.append((sp.op, sp.restart, list(sp.pending)))
    return g.checkpoints, g.fired, out


def _both(calls, **kw):
    """The port's trace, checked equal to the reference's."""
    port = _trace("port", calls, **kw)
    assert port == _trace("reference", calls, **kw)
    return port


def test_borderline_guard_never_fires_as_in_reference():
    spill = _Spill(written=1 << 20, live=1 << 10)
    calls = [("checkpoint", dict(done=[], pending=[("b", "p", 4, 4)],
                                 spill=spill, schema_hint=None))] * 50
    checkpoints, fired, out = _both(calls, t_linear=10.0)
    assert checkpoints == 50 and not fired and out == [None] * 50


def test_profitable_guard_fires_exactly_once_as_in_reference():
    spill = _Spill(written=64 * MB, live=64 * MB)
    pending = [("b", "p", 200_000, 200_000)] * 8
    calls = [("checkpoint", dict(done=[], pending=pending, spill=spill,
                                 schema_hint=None))] * 50
    _, fired, out = _both(calls)
    # the first checkpoint fires; the disarmed guard never fires again
    assert fired and out[0] is not None and out[1:] == [None] * 49
    op, restart, _ = out[0]
    assert op == "hash_join" and not restart


@pytest.mark.parametrize("allow_restart", [False, True])
def test_restart_checkpoint_respects_allow_restart_as_in_reference(
        allow_restart):
    spill = _Spill(written=64 * MB, live=64 * MB)
    calls = [("checkpoint_partition", dict(
        rows_done=100_000, rows_total=1 << 21, files=["a", "b"],
        spill=spill))] * 20
    _, fired, out = _both(calls, allow_restart=allow_restart)
    assert fired == allow_restart
    if allow_restart:
        assert out[0][1] and out[0][2] == ["a", "b"]
    else:
        assert out == [None] * 20


def test_disabled_guard_is_a_plain_token_as_in_reference():
    spill = _Spill(written=64 * MB, live=64 * MB)
    calls = [("checkpoint", dict(done=[], spill=spill, schema_hint=None,
                                 pending=[("b", "p", 10 ** 6, 10 ** 6)] * 8)),
             ("checkpoint_partition", dict(rows_done=1, rows_total=1 << 21,
                                           files=[], spill=spill)),
             ("checkpoint_sort", dict(pending=["r"] * 8, spill=spill)),
             ("check", {})]
    _, fired, out = _both(calls, enabled=False)
    assert not fired and out == [None] * 4


# ---------------------------------------------------------------------------
# Loss-free switches onto the port's tensor path
# ---------------------------------------------------------------------------

def test_restart_switch_is_bit_for_bit(star120, probe_calls):
    """The takeover re-runs the join on the tensor path from the base
    relations: the build keys (a permutation) are unique and dense, so it
    runs the join kernels' route."""
    build, probe, want = star120
    port = _join(_session(T, work_mem=64 * MB, policy="linear"),
                 *_port(build, probe))
    assert port.scalar == want and not probe_calls
    res = _join(_stale(T), *_port(build, probe))
    assert probe_calls
    ref = _join(_stale(R), build, probe)
    assert res.scalar == ref.scalar == want
    sw = _switched(res)
    assert len(sw) == 1, [m.op for m in res.metrics]
    m = sw[0]
    assert m.op == "hash_join"
    assert m.path == "tensor" and m.pre_switch_path == "linear"
    assert m.pre_switch_wall_s > 0 and m.wall_s >= m.pre_switch_wall_s
    assert m.spill.live_bytes == 0
    assert m.spill.bytes_written == m.spill.bytes_freed > 0


def _no_restart(s):
    """``test_pair_boundary_switch_reuses_spilled_partitions``'s session
    setup: eager hysteresis, and guards that may fire only at a pair
    boundary."""
    s.selector.model.c.guard_hysteresis = 0.25
    orig = s.selector.make_guard

    def no_restart_guard(*a, **kw):
        g = orig(*a, **kw)
        if g is not None and hasattr(g, "allow_restart"):
            g.allow_restart = False
        return g

    s.selector.make_guard = no_restart_guard
    return s


def test_pair_boundary_switch_reuses_spilled_partitions(probe_calls):
    """The takeover joins the spilled partitions read back, concatenated,
    on the join kernels' route."""
    build, probe = star_tables(250_000)
    want = _join(R.Session(work_mem=64 * MB, policy="linear"), build,
                 probe).scalar
    res = _join(_no_restart(_stale(T)), *_port(build, probe))
    assert res.scalar == want
    assert probe_calls
    sw = _switched(res)
    assert len(sw) == 1, [m.op for m in res.metrics]
    m = sw[0]
    assert m.path == "tensor" and m.pre_switch_path == "linear"
    assert m.reused_spill_bytes > 0
    assert m.spill.bytes_read >= m.reused_spill_bytes
    assert m.spill.live_bytes == 0
    assert m.spill.bytes_written == m.spill.bytes_freed


def _sort_rel(n=200_000):
    rng = np.random.default_rng(3)
    return R.Relation({"k": rng.integers(0, n, n).astype(np.int64),
                       "w": rng.integers(0, 1 << 30, n).astype(np.int64)})


def test_sort_switch_is_loss_free():
    rel = _sort_rel()
    ref = R.Session(work_mem=64 * MB, policy="linear")
    ref.register("t", rel)
    want = ref.table("t").sort("k", "w").collect().relation
    s = _stale(T, wm=128 * 1024)
    s.register("t", _port(rel))
    res = s.table("t").sort("k", "w").collect()
    sw = _switched(res)
    assert len(sw) == 1, [m.op for m in res.metrics]
    assert sw[0].op == "sort" and sw[0].path == "tensor"
    assert sw[0].pre_switch_path == "linear"
    assert sw[0].spill.live_bytes == 0
    assert sw[0].spill.bytes_written == sw[0].spill.bytes_freed
    for name in want.names:  # the same rows in the same order
        np.testing.assert_array_equal(res.relation[name], want[name])


def test_guards_off_never_switches(star120):
    build, probe, want = star120
    res = _join(_stale(T, guards=False), *_port(build, probe))
    ref = _join(_stale(R, guards=False), build, probe)
    assert res.scalar == ref.scalar == want
    assert not _switched(res)
    ops = [(m.op, m.path) for m in res.metrics]
    assert ops == [(m.op, m.path) for m in ref.metrics]
    assert ("hash_join", "linear") in ops
    m = next(m for m in res.metrics if m.op == "hash_join")
    assert m.spill.bytes_written > 0  # the stale pricing did hit the cliff


def test_switched_run_does_not_pollute_profile(star120):
    build, probe, _ = star120
    s = _stale(T)
    res = _join(s, *_port(build, probe))
    assert _switched(res), "scenario stopped switching; retune"
    polluted = [key for key in s.selector.profile.snapshot()
                if key[0] == "hash_join"]
    assert not polluted, polluted


# ---------------------------------------------------------------------------
# A kernel error during a takeover is not hidden by a fallback
# ---------------------------------------------------------------------------

def _broken(*args, **kwargs):
    raise RuntimeError("join_table_build kernel launch failed: CUDA error 1 "
                       "(invalid argument)")


@pytest.mark.parametrize("where", ["restart", "pair_boundary"])
def test_takeover_kernel_error_propagates(monkeypatch, where):
    """With the device join raising during a guard switch (a mid-partition
    restart, or a pair-boundary takeover that reads the spilled partitions
    back), the query raises: it does not finish on the linear path."""
    import repro_torch.core.executor as E
    import repro_torch.core.tensor_engine as TE

    monkeypatch.setattr(TE, "tensor_join_device", _broken)
    monkeypatch.setattr(E, "tensor_join_device", _broken)
    n = 120_000 if where == "restart" else 250_000
    s = _stale(T)
    if where == "pair_boundary":
        _no_restart(s)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _join(s, *_port(*star_tables(n)))


def test_sort_takeover_kernel_error_propagates(monkeypatch):
    import repro_torch.core.executor as E

    monkeypatch.setattr(E, "tensor_sort_device", _broken)
    s = _stale(T, wm=128 * 1024)
    s.register("t", _port(_sort_rel()))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        s.table("t").sort("k", "w").collect()


# ---------------------------------------------------------------------------
# Chaos hammer: switches under governed concurrent serving with faults
# ---------------------------------------------------------------------------

def test_chaos_switch_hammer():
    """``test_adaptive_guards.test_chaos_switch_hammer``'s server on the
    port: every query served or failed, every served answer the
    reference's serial one bit for bit, never over budget, balanced tier
    books, faults injected.  Switches are counted, not required: where
    the guard fires depends on the race of 8 workers."""
    build, probe = star_tables(60_000)
    ref = R.Session(work_mem=64 * MB)
    ref.register("b", build).register("p", probe)
    expect = (ref.table("p").join("b", on="k").aggregate("b_v", "sum")
              .scalar())
    b, p = _port(build, probe)
    srv = T.QueryServer(
        {"b": b, "p": p}, total_mem=24 * MB, work_mem=512 * 1024,
        min_grant=256 * 1024, device="cpu",
        tiers=T.TierConfig(t1_latency_s=0.0, t1_gbps=1000.0),
        faults=T.FaultInjector(seed=7, spill_io_p=0.01, device_slow_p=0.05,
                               device_slow_s=0.002, grant_timeout_p=0.01,
                               spill_read_p=0.01))
    c = srv.session.selector.model.c
    c.linear_row_cost *= STALE
    c.io_byte_cost *= STALE
    c.guard_hysteresis = 0.5
    q = srv.session.table("p").join("b", on="k").aggregate("b_v", "sum")
    rep = srv.serve([q], concurrency=8, queries_per_worker=4, warmup=1)
    assert rep.counts["served"] + rep.counts["failed"] == 8 * 4, rep.counts
    assert rep.counts["served"] > 0
    for sq in rep.queries:
        assert sq.scalar == expect
    for f in rep.failed:
        assert f.error
    assert rep.governor.over_budget_events == 0
    assert srv.governor.held_bytes == 0
    srv.session.tier_ledger.verify_balanced()
    assert sum(srv.faults.counts().values()) > 0
    assert srv.broker.stats().switches >= 0  # counted, not required


# ---------------------------------------------------------------------------
# Injected device faults: the path fallback of both packages
# ---------------------------------------------------------------------------

def _fallback_runs(M, build, probe, faults):
    """Two runs of the join through a ``policy="tensor"`` session whose
    broker carries ``faults`` (the device-dispatch fault site is the
    broker's device lease).  The first run of a new fused program takes
    no lease (the fresh-program bypass), so the second is the one the
    faults reach."""
    s = _session(M, work_mem=1 * MB, policy="tensor",
                 broker=M.ResourceBroker(None, faults=faults))
    return [_join(s, build, probe) for _ in range(2)]


def test_injected_device_faults_fall_back_to_linear_as_in_reference():
    """``device_fail_p=1.0``: every device lease fails, so after
    ``RetryPolicy.device_fallback_after`` failures the fused-eligible
    query runs linear, each decision's reason marked ``device-fallback``,
    with the reference's answer, ops and paths.  Without an injector no
    reason says so."""
    build, probe = star_tables(30_000)
    pb, pp = _port(build, probe)
    refs = _fallback_runs(R, build, probe,
                          R.FaultInjector(seed=0, device_fail_p=1.0))
    inj = T.FaultInjector(seed=0, device_fail_p=1.0)
    runs = _fallback_runs(T, pb, pp, inj)
    for res, ref in zip(runs, refs):
        assert res.scalar == ref.scalar
        assert ([(m.op, m.path) for m in res.metrics]
                == [(m.op, m.path) for m in ref.metrics])
        assert ([d.reason for d in res.decisions]
                == [d.reason for d in ref.decisions])
    res = runs[1]
    assert res.metrics and all(m.path == "linear" for m in res.metrics)
    assert res.decisions and all(d.reason.startswith("device-fallback")
                                 for d in res.decisions)
    assert (inj.counts()["device_fail"]
            >= T.RetryPolicy().device_fallback_after)
    for healthy in _fallback_runs(T, pb, pp, None):
        assert healthy.scalar == refs[0].scalar
        assert [m.op for m in healthy.metrics] == ["fused_pipeline"]
        assert not any(d.reason.startswith("device-fallback")
                       for d in healthy.decisions)
