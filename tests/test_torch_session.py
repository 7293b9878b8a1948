"""The slice as a whole: ``repro_torch.core.Session`` against
``repro.core.Session`` on the CPU.

Both engines get the same tables (handed across as numpy through
``repro_torch.core.interop``) and the same cost constants, and must agree:
the README star join (its stage chain, its answer, its warm H2D bytes), and
seeded plans of the differential fuzz generator of
``tests/test_differential_fuzz.py`` under the linear, tensor and auto
policies.  Answers compare exactly: the values are int64 or float64 sums of
small integers, far below 2**53.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from test_differential_fuzz import (Case, assert_same, assert_sorted,  # noqa: E402
                                    canon, oracle, run_case)
from test_session import _star_tables  # noqa: E402

MB = 1 << 20


def _port_session(policy, work_mem=1 << 20, **kw):
    """A port session whose selector prices with the reference's constants
    (carried across as a plain dict)."""
    consts = T.cost_constants_from_dict(
        dataclasses.asdict(R.CostModel().c))
    force = None if policy == "auto" else policy
    sel = T.PathSelector(work_mem, cost_model=T.CostModel(consts),
                         force=force, profile=T.RuntimeProfile())
    return T.Session(work_mem=work_mem, policy=policy, selector=sel,
                     device="cpu", **kw)


def _star_query(sess, M):
    return (sess.table("orders")
            .join(sess.table("users"), on="uid")
            .join(sess.table("parts"), on="pid")
            .filter((M.col("w") > 0) & (M.col("b_region") <= 2))
            .sort("uid")
            .aggregate("w", "sum"))


def _star_sessions(policy, seed=0, n_orders=20_000):
    orders, users, parts = _star_tables(seed=seed, n_orders=n_orders)
    ref = R.Session(work_mem=1 << 20, policy=policy)
    port = _port_session(policy)
    tables = T.tables_from_numpy({
        name: rel.columns for name, rel in
        (("orders", orders), ("users", users), ("parts", parts))})
    for name, rel in (("orders", orders), ("users", users),
                      ("parts", parts)):
        ref.register(name, rel)
        port.register(name, tables[name])
    return ref, port


def test_star_join_matches_reference():
    ref, port = _star_sessions("tensor")
    q_ref, q_port = _star_query(ref, R), _star_query(port, T)
    assert q_port.explain() == q_ref.explain()
    res_ref, res_port = q_ref.collect(), q_port.collect()
    assert [m.op for m in res_port.metrics] == ["fused_pipeline",
                                                "fused_pipeline"]
    assert ([m.op for m in res_port.metrics]
            == [m.op for m in res_ref.metrics])
    assert res_port.scalar == res_ref.scalar
    assert res_port.total_host_syncs == res_ref.total_host_syncs
    assert res_port.total_h2d_bytes == res_ref.total_h2d_bytes > 0
    assert (res_port.total_h2d_bytes_logical
            == res_ref.total_h2d_bytes_logical)
    # warm: the base tables stay resident; only the first stage's output
    # (a fresh relation per query) crosses again, exactly as in the
    # reference
    warm, warm_ref = q_port.collect(), q_ref.collect()
    assert warm.scalar == res_ref.scalar
    assert warm.total_h2d_bytes == warm_ref.total_h2d_bytes
    assert warm.total_h2d_bytes < res_port.total_h2d_bytes
    assert warm.total_host_syncs == 2  # one fetch per chained fragment


@pytest.mark.parametrize("policy", ["linear", "tensor", "auto"])
def test_star_join_policies_match_reference(policy):
    ref, port = _star_sessions(policy, seed=5, n_orders=4000)
    res_ref = _star_query(ref, R).collect()
    res_port = _star_query(port, T).collect()
    assert res_port.scalar == res_ref.scalar
    assert ([d.path for d in res_port.decisions]
            == [d.path for d in res_ref.decisions])


def _case_query(sess, M, case: Case):
    """The fuzz harness's plan for ``case`` over engine module ``M``."""
    sess.register("p", M.Relation(dict(case.probe)))
    sess.register("b", M.Relation(dict(case.build)))
    q = sess.table("p").join("b", on="k")
    if case.filter_thr is not None:
        q = q.filter(M.col("w") > case.filter_thr)
    if case.root == "sort":
        q = q.sort("k", "w")
    elif case.root == "group":
        q = q.group_by("k", {"b_v": case.fn})
    elif case.root == "agg":
        q = q.aggregate("b_v", case.fn)
    return q


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_plans_match_reference(seed):
    """The fuzz generator's seeded plans: the port equals the reference (its
    own ``run_case``) and the numpy oracle under every policy."""
    case = Case(np.random.default_rng(1000 + seed), max_rows=300)
    want = oracle(case)
    for policy in ("linear", "tensor", "auto"):
        ctx = f"[{policy}] seed={seed} {case.describe()}"
        res = _case_query(_port_session(policy, 64 * MB), T, case).collect()
        got = res.scalar if case.root == "agg" else res.relation
        assert_same(got, want, ctx)
        ref_got = run_case(R.Session(work_mem=64 * MB, policy=policy), case)
        if case.root == "agg":
            assert got == ref_got, ctx
            continue
        if case.root == "sort":
            assert_sorted(got, ("k", "w"))
            for name in ref_got.names:  # same rows in the same order
                np.testing.assert_array_equal(got[name], ref_got[name],
                                              err_msg=ctx)
        gn, ga = canon({n: got[n] for n in got.names})
        rn, ra = canon({n: ref_got[n] for n in ref_got.names})
        assert gn == rn, ctx
        for g, r in zip(ga, ra):
            np.testing.assert_array_equal(g, r, err_msg=ctx)


def test_fuzz_first_decisions_match_reference():
    """Fresh sessions under ``auto`` decide the same paths on the same plan
    (no runtime feedback yet: the cost model alone decides)."""
    for seed in range(6):
        case = Case(np.random.default_rng(2000 + seed), max_rows=300)
        res = _case_query(_port_session("auto", 64 * MB), T,
                          case).collect()
        ref_res = _case_query(R.Session(work_mem=64 * MB, policy="auto"), R,
                              case).collect()
        assert ([d.path for d in res.decisions]
                == [d.path for d in ref_res.decisions]), case.describe()


@pytest.mark.parametrize("work_mem", [1 << 30, 32 * 1024])
def test_linear_engine_matches_reference(work_mem):
    """The host linear path came over as it was: the same joins, sorts and
    GROUP BYs, and the same spill volume, under a roomy and a tight
    work_mem."""
    rng = np.random.default_rng(21)
    b = {"k": rng.integers(0, 300, 3000).astype(np.int64),
         "v": rng.integers(0, 1 << 30, 3000).astype(np.int64)}
    p = {"k": rng.integers(0, 300, 5000).astype(np.int64),
         "w": rng.integers(0, 1 << 30, 5000).astype(np.int64)}
    (bj, bt), (pj, pt) = ((R.Relation(dict(x)), T.Relation(dict(x)))
                          for x in (b, p))
    jt, mt = T.hash_join_linear(bt, pt, "k", work_mem)
    jj, mj = R.hash_join_linear(bj, pj, "k", work_mem)
    assert jt.sort_canonical().equals(jj.sort_canonical())
    st, mst = T.sort_linear(jt, ["k", "w"], work_mem)
    sj, msj = R.sort_linear(jj, ["k", "w"], work_mem)
    for name in sj.names:
        np.testing.assert_array_equal(st[name], sj[name])
    gt, mgt = T.group_aggregate_linear(pt, "k", {"w": "sum"}, work_mem)
    gj, mgj = R.group_aggregate_linear(pj, "k", {"w": "sum"}, work_mem)
    assert gt.sort_canonical().equals(gj.sort_canonical())
    for a, c in ((mt, mj), (mst, msj), (mgt, mgj)):
        assert (a.spill.bytes_written, a.spill.bytes_read,
                a.spill.partition_passes) == (c.spill.bytes_written,
                                              c.spill.bytes_read,
                                              c.spill.partition_passes)
    if work_mem < 1 << 20:
        assert mt.spill.bytes_written > 0
