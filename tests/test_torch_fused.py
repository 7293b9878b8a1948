"""Parity of the port's fused device fragment (``repro_torch.core.fused.
run_fused``) with the reference's, on the CPU.

Every case runs the same fragment over the same numpy tables through both
engines and compares the output (scalars and integer columns exactly, rows
in the same order), the host syncs, the physical and logical H2D bytes and
the row count.  The cases cover the three join cores (value-dense,
dictionary code domain, sorted), the has_dup and capacity-overflow retries,
and scalar, relation and projected roots.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import fused as jfused  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import fused as tfused  # noqa: E402


def _both(cols):
    return R.Relation(dict(cols)), T.Relation(dict(cols))


def _specs():
    """(name, spec factory over an engine module) for the fragment shapes."""
    return {
        "sort_sum": lambda M: M.FusedSpec("k", None, ("k",), ("b_v", "sum")),
        "filter_sort_sum": lambda M: M.FusedSpec(
            "k", M.col("w") > 0, ("k", "w"), ("w", "sum")),
        "filter_count": lambda M: M.FusedSpec(
            "k", (M.col("w") % 2) == 0, (), ("b_v", "count")),
        "min": lambda M: M.FusedSpec("k", None, (), ("b_v", "min")),
        "max_sorted": lambda M: M.FusedSpec("k", None, ("w",), ("w", "max")),
        "relation_sorted": lambda M: M.FusedSpec(
            "k", M.col("b_v") >= 0, ("k", "w"), None),
        "projected": lambda M: M.FusedSpec("k", None, ("w", "k"), None,
                                           project=("k", "b_v")),
    }


def _tables_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "dense_unique":
        n_b, n_p = 3000, 4000
        bk = rng.permutation(n_b).astype(np.int64) + 11
        pk = rng.integers(0, n_b + 40, n_p).astype(np.int64)
    elif name == "sorted_duplicates":
        n_b, n_p = 4000, 4000
        bk = rng.integers(0, 17, n_b).astype(np.int64)
        pk = rng.integers(0, 20, n_p).astype(np.int64)
    elif name == "sparse_wide":
        n_b, n_p = 2000, 3000
        bk = rng.permutation(n_b).astype(np.int64) * 10**9
        pk = rng.integers(0, n_b, n_p).astype(np.int64) * 10**9
    elif name == "dense_hidden_duplicates":
        # the 65536-row key sample looks unique: dense core first, has_dup
        # on device, retry on the sorted core
        n_b, n_p = 70_000, 4096
        bk = np.arange(n_b, dtype=np.int64)
        bk[65536:65736] = 1
        pk = rng.integers(0, 2000, n_p).astype(np.int64)
    elif name == "dict_code_domain":
        # wide sparse values, dictionary-encoded (half the strided layout
        # sample repeats one value) while the first 65536 rows are unique:
        # the code-domain dense core runs, sees the duplicates, retries
        n_b, n_p = 140_000, 3000
        vals = np.unique(rng.integers(0, 1 << 50, 70_000))[:65536]
        bk = np.concatenate([vals, np.full(n_b - len(vals), vals[3])])
        pk = rng.choice(vals[:5000], n_p)
    elif name == "capacity_overflow":
        # duplication estimate ~2 while the probe only hits the heavy key
        n_b, n_p = 200, 100
        bk = np.concatenate([np.zeros(100, np.int64),
                             np.arange(1, 101, dtype=np.int64)])
        pk = np.zeros(n_p, np.int64)
    else:
        raise KeyError(name)
    build = {"k": bk, "v": rng.integers(-99, 99, n_b).astype(np.int64)}
    probe = {"k": pk, "w": rng.integers(-99, 99, n_p).astype(np.int64)}
    return build, probe


# the fragment shapes each table case runs (every shape on the plain dense
# case; the retry cases keep the suite fast with a scalar and a relation
# root each)
CASES = {
    "dense_unique": tuple(_specs()),
    "sorted_duplicates": ("sort_sum", "relation_sorted", "projected"),
    "sparse_wide": ("filter_sort_sum", "min"),
    "dense_hidden_duplicates": ("sort_sum", "projected"),
    "dict_code_domain": ("filter_count", "relation_sorted"),
    "capacity_overflow": ("max_sorted", "projected"),
}


def _compare(res_t, m_t, res_j, m_j, ctx):
    if isinstance(res_j, float):
        assert isinstance(res_t, float), ctx
        assert res_t == res_j, ctx
    else:
        assert set(res_t.names) == set(res_j.names), ctx
        for k in res_j.names:
            np.testing.assert_array_equal(res_t[k], res_j[k], err_msg=ctx)
            assert res_t[k].dtype == res_j[k].dtype, ctx
    assert m_t.host_syncs == m_j.host_syncs, ctx
    assert m_t.h2d_bytes == m_j.h2d_bytes, ctx
    assert m_t.h2d_bytes_logical == m_j.h2d_bytes_logical, ctx
    assert m_t.rows_out == m_j.rows_out, ctx


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_fused_matches_reference(case):
    build, probe = _tables_case(case)
    bj, bt = _both(build)
    pj, pt = _both(probe)
    syncs = set()
    specs = _specs()
    for name in CASES[case]:
        mk = specs[name]
        res_j, m_j = jfused.run_fused(mk(R), bj, pj)
        res_t, m_t = tfused.run_fused(mk(T), bt, pt, device="cpu")
        _compare(res_t, m_t, res_j, m_j, f"{case}/{name}")
        syncs.add(m_t.host_syncs)
    # the retry cases really retried; the others fetched once
    if case in ("dense_hidden_duplicates", "dict_code_domain",
                "capacity_overflow"):
        assert max(syncs) >= 2, syncs
    else:
        assert syncs == {1}, syncs


def test_fused_plans_pick_the_reference_cores():
    """_host_plan makes the same capacity / dense-domain decision."""
    for case in CASES:
        build, probe = _tables_case(case)
        bj, bt = _both(build)
        pj, pt = _both(probe)
        assert (tfused._host_plan(bt, pt, "k")
                == jfused._host_plan(bj, pj, "k")), case


def test_pipeline_cache_counts_match_reference():
    build, probe = _tables_case("dense_unique")
    counts = {}
    for M, F, dev in ((R, jfused, {}), (T, tfused, {"device": "cpu"})):
        F.pipeline_cache_clear()
        bx, px = M.Relation(dict(build)), M.Relation(dict(probe))
        compiled = []
        for _ in range(3):
            _, m = F.run_fused(M.FusedSpec("k", M.col("w") > 3, ("k",),
                                           ("b_v", "sum")), bx, px, **dev)
            compiled.append(m.compiled)
        counts[M.__name__] = (F.pipeline_cache_info(), compiled)
    assert counts["repro.core"] == counts["repro_torch.core"]
    assert counts["repro_torch.core"][1] == [True, False, False]


def test_empty_min_raises_like_reference():
    build = {"k": np.arange(10, dtype=np.int64),
             "v": np.arange(10, dtype=np.int64)}
    probe = {"k": np.arange(100, 110, dtype=np.int64),
             "w": np.zeros(10, np.int64)}
    for M, F, kw in ((R, jfused, {}), (T, tfused, {"device": "cpu"})):
        with pytest.raises(ValueError, match="no identity"):
            F.run_fused(M.FusedSpec("k", None, (), ("b_v", "min")),
                        M.Relation(dict(build)), M.Relation(dict(probe)),
                        **kw)


def test_host_predicate_falls_back_to_the_generic_walk():
    """A predicate that needs host numpy cannot run in the fused program;
    the executor answers it on the generic walk, like the reference."""
    build, probe = _tables_case("dense_unique")

    def host_only(r):
        return np.asarray(r["w"]) > 0

    answers = {}
    for M in (R, T):
        kw = {"device": "cpu"} if M is T else {}
        plan = M.Aggregate(M.Filter(M.Join(M.Scan(M.Relation(dict(build))),
                                           M.Scan(M.Relation(dict(probe))),
                                           "k"), host_only), "b_v", "sum")
        res = M.Executor(work_mem=1 << 30, policy="tensor", **kw).execute(plan)
        assert "fused_pipeline" not in [m.op for m in res.metrics]
        answers[M.__name__] = res.scalar
    assert answers["repro.core"] == answers["repro_torch.core"]
    with pytest.raises(T.PredicateError):
        tfused.run_fused(T.FusedSpec("k", host_only, (), ("b_v", "sum")),
                         T.Relation(dict(build)), T.Relation(dict(probe)),
                         device="cpu")


def test_kernel_errors_are_not_hidden_by_a_fallback(monkeypatch):
    """Anything but a predicate failure propagates out of the executor
    (the reference re-ran every failing fragment on the generic walk)."""
    import repro_torch.core.fused as F

    def broken(*args, **kwargs):
        raise RuntimeError("join_table_build kernel launch failed: CUDA "
                           "error 1 (invalid argument)")

    monkeypatch.setattr(F, "radix_hash_probe_dispatch", broken)
    build, probe = _tables_case("dense_unique")
    plan = T.Aggregate(T.Sort(T.Join(T.Scan(T.Relation(dict(build))),
                                     T.Scan(T.Relation(dict(probe))), "k"),
                              ["k"]), "b_v", "sum")
    ex = T.Executor(work_mem=1 << 30, policy="tensor", device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ex.execute(plan)


def test_fused_fetch_is_one_batched_copy(monkeypatch):
    """The happy path fetches once: one to_host call for all outputs."""
    import repro_torch.core.fused as F

    calls = []
    real = F.to_host

    def counting(tensors):
        calls.append(len(tensors))
        return real(tensors)

    monkeypatch.setattr(F, "to_host", counting)
    build, probe = _tables_case("dense_unique")
    res, m = F.run_fused(T.FusedSpec("k", None, ("k",), None,
                                     project=("k", "w", "b_v")),
                         T.Relation(dict(build)), T.Relation(dict(probe)),
                         device="cpu")
    assert m.host_syncs == 1 and len(calls) == 1
    assert calls[0] == 2 + 1 + 3  # total, has_dup, valid + three columns


def _unsigned_tables(seed=0):
    """A build side with uint32 and uint64 payloads (uint64 values on both
    sides of 2**63, repeated so that the second key breaks ties)."""
    rng = np.random.default_rng(seed)
    n_b, n_p = 500, 2000
    u64 = rng.integers(0, 1 << 62, 40, dtype=np.uint64) * np.uint64(4)
    u64[::2] |= np.uint64(1 << 63)
    build = {"k": np.arange(n_b, dtype=np.int64),
             "u32": rng.integers(0, 1 << 32, n_b,
                                 dtype=np.uint64).astype(np.uint32),
             "u64": rng.choice(u64, n_b)}
    probe = {"k": rng.integers(0, n_b + 20, n_p).astype(np.int64),
             "w": rng.integers(-50, 50, n_p).astype(np.int64)}
    return build, probe


def _unsigned_query(sess, M):
    return (sess.table("p").join("b", on="k").filter(M.col("w") > 0)
            .sort("b_u64", "b_u32", "w"))


def test_fused_sort_on_unsigned_keys_matches_reference():
    """The fused fragment sorts uint32 and uint64 keys (mapped to signed
    keys of the same order) into the reference's rows."""
    build, probe = _unsigned_tables()
    out = {}
    for M, kw in ((R, {}), (T, {"device": "cpu"})):
        sess = M.Session(work_mem=1 << 20, policy="tensor", **kw)
        sess.register("p", probe)
        sess.register("b", build)
        out[M] = _unsigned_query(sess, M).collect()
    got, want = out[T], out[R]
    assert [m.op for m in got.metrics] == ["fused_pipeline"]
    assert set(got.relation.names) == set(want.relation.names)
    for k in want.relation.names:
        np.testing.assert_array_equal(got.relation[k], want.relation[k])
        assert got.relation[k].dtype == want.relation[k].dtype
    u64 = got.relation["b_u64"]
    assert (u64[:-1] <= u64[1:]).all() and u64[-1] >= np.uint64(1 << 63)
