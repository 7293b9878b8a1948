"""Parity of the port's fused device fragment (``repro_torch.core.fused.
run_fused``) with the reference's, on the CPU.

Every case runs the same fragment over the same numpy tables through both
engines and compares the output (scalars and integer columns exactly, rows
in the same order), the host syncs, the physical and logical H2D bytes and
the row count.  The cases cover the three join cores (value-dense,
dictionary code domain, sorted), the has_dup and capacity-overflow retries,
and scalar, relation and projected roots.  The survivor bucket, which the
reference does not have, is held to the reference's answers over repeated
runs, where later runs compact the filtered join slots.
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


def _compare(res_t, m_t, res_j, m_j, ctx, extra_syncs=0):
    if isinstance(res_j, float):
        assert isinstance(res_t, float), ctx
        assert res_t == res_j, ctx
    else:
        assert set(res_t.names) == set(res_j.names), ctx
        for k in res_j.names:
            np.testing.assert_array_equal(res_t[k], res_j[k], err_msg=ctx)
            assert res_t[k].dtype == res_j[k].dtype, ctx
    assert m_t.host_syncs == m_j.host_syncs + extra_syncs, ctx
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
    F.pipeline_cache_clear()
    build, probe = _tables_case("dense_unique")
    bt, pt = T.Relation(dict(build)), T.Relation(dict(probe))
    spec = T.FusedSpec("k", T.col("w") > 50, ("k",), None,
                       project=("k", "w", "b_v"))
    for _ in range(2):
        res, m = F.run_fused(spec, bt, pt, device="cpu")
        assert m.host_syncs == 1
    assert len(calls) == 2
    # total, has_dup, kept, valid + three columns, the second run's over
    # the survivor bucket
    assert calls == [3 + 1 + 3] * 2


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


# ---------------------------------------------------------------------------
# The survivor bucket: a fragment's later runs over the same data compact
# the join slots that pass the filter before the sort, the gathers and the
# fetch (the reference runs every query over the whole capacity)
# ---------------------------------------------------------------------------

def _launches(fn):
    """``fn()`` with the span recorder on: what it returns, and the
    ``(capacity, bucket)`` of each fused launch it made."""
    from repro_torch.core import metrics as tm

    tm.start_spans()
    try:
        out = fn()
    finally:
        got = tm.stop_spans()
    return out, [(s.attrs["capacity"], s.attrs["bucket"]) for s in got
                 if s.name == "launch"]


def _runs(spec, build, probe, times):
    """``times`` runs of the reference and of the port, the port's from a
    cleared program cache: ``[((result, metrics) of the reference,
    (result, metrics, launches) of the port)]``."""
    bj, bt = _both(build)
    pj, pt = _both(probe)
    tfused.pipeline_cache_clear()
    out = []
    for _ in range(times):
        want = jfused.run_fused(spec(R), bj, pj)
        (res, m), launches = _launches(
            lambda: tfused.run_fused(spec(T), bt, pt, device="cpu"))
        out.append((want, (res, m, launches)))
    return out


def test_selective_filter_compacts_after_the_first_run():
    """The first run counts the survivors over the whole capacity; the next
    ones sort, gather and fetch a bucket of them, into the same rows in the
    same order, with one sync each and the program cache's counts."""
    def spec(M):
        return M.FusedSpec("k", M.col("w") > 80, ("b_v", "k"), None)

    runs = _runs(spec, *_tables_case("dense_unique"), 3)
    got = [port for _, port in runs]
    cap = got[0][2][0][0]
    bucket = tfused.capacity_bucket(len(runs[0][0][0]))
    assert bucket < cap // 4
    for i, ((res_j, m_j), (res_t, m_t, _)) in enumerate(runs):
        _compare(res_t, m_t, res_j, m_j, f"run {i}")
        assert m_t.host_syncs == 1
    assert [m.compiled for _, m, _ in got] == [True, False, False]
    assert [launches for _, _, launches in got] == [
        [(cap, cap)], [(cap, bucket)], [(cap, bucket)]]


def test_compacted_ties_keep_probe_row_order():
    """Rows whose sort keys tie keep the order of the probe side's rows
    (``w`` numbers them) once compacted, as the reference orders them."""
    rng = np.random.default_rng(31)
    build = {"k": np.arange(500, dtype=np.int64),
             "v": rng.integers(0, 3, 500).astype(np.int64)}
    probe = {"k": rng.integers(0, 500, 3000).astype(np.int64),
             "w": np.arange(3000, dtype=np.int64)}

    def spec(M):
        return M.FusedSpec("k", (M.col("w") % 7) == 0, ("b_v",), None)

    (res_j, m_j), (res_t, m_t, launches) = _runs(spec, build, probe, 2)[1]
    assert launches[0][1] < launches[0][0]
    _compare(res_t, m_t, res_j, m_j, "ties")
    v, w = res_t["b_v"], res_t["w"]
    assert (np.diff(v) >= 0).all()
    assert (np.diff(w)[np.diff(v) == 0] > 0).all()


def test_the_bucket_hint_holds_across_literals():
    """The hint belongs to the fragment's template, not to its literals: a
    literal that keeps fewer rows compacts into the bucket its first
    literal sized, and one that keeps more re-runs once and raises it."""
    build, probe = _tables_case("dense_unique")
    bj, bt = _both(build)
    pj, pt = _both(probe)

    def spec(M, lit):
        return M.FusedSpec("k", M.col("w") > lit, ("k",), None)

    tfused.pipeline_cache_clear()
    seen = []
    for lit in (80, 85, 60):
        res_j, m_j = jfused.run_fused(spec(R, lit), bj, pj)
        (res_t, m_t), launches = _launches(
            lambda: tfused.run_fused(spec(T, lit), bt, pt, device="cpu"))
        seen.append((len(res_j), m_t.host_syncs, launches))
        _compare(res_t, m_t, res_j, m_j, f"w > {lit}",
                 extra_syncs=m_t.host_syncs - 1)
    (n80, s80, l80), (n85, s85, l85), (n60, s60, l60) = seen
    cap, b80 = l80[0][0], tfused.capacity_bucket(n80)
    assert n85 < n80 < n60 and tfused.capacity_bucket(n60) > b80
    assert (s80, l80) == (1, [(cap, cap)])
    assert (s85, l85) == (1, [(cap, b80)])
    assert (s60, l60) == (2, [(cap, b80),
                              (cap, tfused.capacity_bucket(n60))])


@pytest.mark.parametrize("root", ["relation", "sum"])
def test_a_stale_bucket_hint_costs_one_retry(root):
    """A hint smaller than the survivors: the program compacts into it,
    the fetched count shows more, and one re-run on a bucket that holds
    them gives the reference's answer: the one case with a sync more than
    the reference's."""
    agg = None if root == "relation" else ("b_v", "sum")

    def spec(M):
        return M.FusedSpec("k", M.col("w") > 20, ("k",), agg)

    build, probe = _tables_case("dense_unique")
    bj, bt = _both(build)
    pj, pt = _both(probe)
    res_j, m_j = jfused.run_fused(spec(R), bj, pj)
    tfused.pipeline_cache_clear()
    key = tfused._bucket_key(spec(T), bt, pt)
    tfused._BUCKET_HINTS.raise_to(key, 4)
    (res_t, m_t), launches = _launches(
        lambda: tfused.run_fused(spec(T), bt, pt, device="cpu"))
    _compare(res_t, m_t, res_j, m_j, root, extra_syncs=1)
    assert m_t.host_syncs == 2
    # the re-run's bucket is the survivors' own, and now the hint
    assert [b for _, b in launches] == [4, tfused._BUCKET_HINTS.get(key)]
    assert launches[1][1] > 4


@pytest.mark.parametrize("name", ["keeps_almost_all", "no_filter"])
def test_wide_survivor_sets_run_uncompacted(name):
    """Where the survivors' bucket is the capacity itself, the program
    skips the compaction: today's path, at no cost."""
    rng = np.random.default_rng(5)
    build = {"k": np.arange(1000, dtype=np.int64),
             "v": rng.integers(-99, 99, 1000).astype(np.int64)}
    probe = {"k": rng.integers(0, 1000, 4000).astype(np.int64),
             "w": rng.integers(0, 1000, 4000).astype(np.int64)}

    def spec(M):
        return M.FusedSpec(
            "k", M.col("w") > 5 if name == "keeps_almost_all" else None,
            ("b_v", "w"), None)

    for (res_j, m_j), (res_t, m_t, launches) in _runs(spec, build, probe,
                                                       2):
        _compare(res_t, m_t, res_j, m_j, name)
        assert len(launches) == 1
        assert launches[0][0] == launches[0][1]


@pytest.mark.parametrize("fn", ["min", "max"])
def test_empty_survivors_still_raise_once_compacted(fn):
    build, probe = _tables_case("dense_unique")

    def spec(M):
        return M.FusedSpec("k", M.col("w") > 1000, ("k",), ("b_v", fn))

    bj, bt = _both(build)
    pj, pt = _both(probe)
    with pytest.raises(ValueError, match="no identity"):
        jfused.run_fused(spec(R), bj, pj)
    tfused.pipeline_cache_clear()
    buckets = []
    for _ in range(2):
        with pytest.raises(ValueError, match="no identity"):
            tfused.run_fused(spec(T), bt, pt, device="cpu")
        buckets.append(tfused._BUCKET_HINTS.get(
            tfused._bucket_key(spec(T), bt, pt)))
    # the second run compacted into the least bucket
    assert buckets == [tfused.capacity_bucket(0)] * 2
    assert buckets[0] < tfused._host_plan(bt, pt, "k")[0]


def _float_sum_tables(seed):
    """Terms over sixteen orders of magnitude and both signs, where another
    grouping of the sum shows in its bits."""
    rng = np.random.default_rng(seed)
    build = {"k": np.arange(3000, dtype=np.int64),
             "v": rng.integers(-99, 99, 3000).astype(np.int64)}
    x = rng.standard_normal(8000) * 10.0 ** rng.integers(-8, 8, 8000)
    probe = {"k": rng.integers(0, 3000, 8000).astype(np.int64), "x": x,
             "w": rng.integers(-9, 9, 8000)}
    return build, probe


def _assert_sum_near(got, want, terms, ctx):
    """``got`` is ``want`` where the engines reduce alike, else within
    1e-12 of the terms' absolute sum, which a dropped or repeated large
    term leaves far behind."""
    assert abs(got - want) <= 1e-12 * float(np.abs(terms).sum()), ctx


@pytest.mark.parametrize("sort_keys", [(), ("b_v", "k")])
def test_a_compacted_float_sum_keeps_its_bits(sort_keys):
    """A sorted float sum reduces its survivors in sorted order, laid out
    over the capacity, in either program, so the compacted run returns the
    first run's bits; an unsorted one has no sort to spare and is never
    compacted.  Both runs hold the reference's sum."""
    build, probe = _float_sum_tables(2)

    def spec(M):
        return M.FusedSpec("k", M.col("w") > 3, sort_keys, ("x", "sum"))

    runs = _runs(spec, build, probe, 2)
    (_, (first, _, l1)), (_, (second, _, l2)) = runs
    assert l1[0][1] == l1[0][0]
    assert (l2[0][1] < l2[0][0]) == bool(sort_keys)
    assert first == second
    for (res_j, m_j), (res_t, m_t, _) in runs:
        _assert_sum_near(res_t, res_j, probe["x"], sort_keys)
        assert m_t.host_syncs == m_j.host_syncs
        assert m_t.rows_out == m_j.rows_out
        assert m_t.h2d_bytes == m_j.h2d_bytes


@pytest.mark.parametrize("first", ["float", "uint8"])
@pytest.mark.parametrize("root", ["relation", "sum"])
def test_survivors_tied_with_the_sink_value_survive(first, root):
    """Filtered-out rows sink under the first sort key's largest value
    (+inf for a float, 255 for uint8); survivors that hold it, or NaN,
    sort among them, and the second key (``w``, larger on every survivor)
    puts them after some.  The fetched validity keeps exactly the
    survivors, in the reference's order, on the first run and on the
    compacted one; a sorted float sum keeps its bits."""
    rng = np.random.default_rng(17)
    n_b, n_p = 400, 8000
    if first == "float":
        s = rng.choice(np.array([-1.0, 0.5, np.inf, np.nan]), n_b)
    else:
        s = rng.choice(np.array([0, 7, 255], np.uint8), n_b)
    build = {"k": np.arange(n_b, dtype=np.int64), "s": s}
    x = rng.standard_normal(n_p) * 10.0 ** rng.integers(-8, 8, n_p)
    probe = {"k": rng.integers(0, n_b, n_p).astype(np.int64),
             "w": rng.integers(0, 100, n_p).astype(np.int64), "x": x}
    agg = None if root == "relation" else ("x", "sum")

    def spec(M):
        return M.FusedSpec("k", M.col("w") > 50, ("b_s", "w"), agg)

    runs = _runs(spec, build, probe, 2)
    assert [launches[0][1] < launches[0][0]
            for _, (_, _, launches) in runs] == [False, True]
    for i, ((res_j, m_j), (res_t, m_t, _)) in enumerate(runs):
        if root == "relation":
            _compare(res_t, m_t, res_j, m_j, f"run {i}")
            assert len(res_t) == int((probe["w"] > 50).sum())
        else:
            _assert_sum_near(res_t, res_j, x, f"run {i}")
            assert m_t.host_syncs == m_j.host_syncs == 1
    if root == "sum":
        assert runs[0][1][0] == runs[1][1][0]


def test_bucket_hints_lose_no_raise_under_threads():
    """Concurrent queries raise one hint table: each key ends at the
    largest size any thread raised it to."""
    import sys
    import threading

    hints = tfused._Hints()
    keys = [("k", i) for i in range(4)]
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 1 << 20, (16, 4000))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda row=row: [
            hints.raise_to(keys[j % 4], int(v)) for j, v in enumerate(row)])
            for row in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for j, key in enumerate(keys):
        assert hints.get(key) == int(sizes[:, j::4].max())
