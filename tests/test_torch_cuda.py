"""Tests that need the CUDA card: the hand-written kernels against their
plain versions, and the port's main path on the card against the same
engine on the CPU.  They carry the ``cuda`` marker and skip, with a reason,
on a machine without a card.  They import neither JAX nor the reference, so
they run on the card's machine as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

RTOL = 1e-12  # float64 sums whose atomics land in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks "
                    "there too)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def test_kernels_match_plain_versions(dev):
    """Each kernel against its plain version: integers exact, float64 sums
    within rtol 1e-12; out-of-range ids and codes included."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(5)
    ids = _t(rng.integers(-2, 70, 50_000).astype(np.int32), dev)
    for g, w in zip(kernel.radix_rank(ids, 64), ref.radix_rank_ref(ids, 64)):
        assert torch.equal(g, w)
    bk = _t(rng.integers(-5, 3000, 20_000).astype(np.int32), dev)
    brow = torch.arange(20_000, dtype=torch.int32, device=dev)
    got = kernel.join_table_build(bk, brow, 2048)
    want = ref.join_table_build_ref(bk, brow, 2048)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    pk = _t(rng.integers(-5, 3000, 30_000).astype(np.int32), dev)
    for g, w in zip(kernel.join_table_probe(pk, *got),
                    ref.join_table_probe_ref(pk, *got)):
        assert torch.equal(g, w)
    seg = _t(np.sort(rng.integers(-3, 500, 40_000)).astype(np.int32), dev)
    val = _t(rng.normal(size=40_000), dev)
    torch.testing.assert_close(kernel.segment_sum(seg, val, 512),
                               ref.segment_sum_ref(seg, val, 512),
                               rtol=RTOL, atol=1e-12)


def test_radix_rank_past_shared_memory(dev):
    """More buckets than a block's shared memory holds: the rank pass works
    on the global histogram row in place, and must still be stable."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(8)
    nb = 100_000  # 400 KB of int32 per tile row
    ids = _t(rng.integers(0, nb, 70_000).astype(np.int32), dev)
    for g, w in zip(kernel.radix_rank(ids, nb), ref.radix_rank_ref(ids, nb)):
        assert torch.equal(g, w)


def test_radix_hash_probe_on_card_matches_cpu(dev):
    from repro_torch.kernels.segment_join import ops

    rng = np.random.default_rng(3)
    domain = 1 << 20
    bk = rng.permutation(domain)[:300_000].astype(np.int32)
    bk[:1000] = domain  # dead rows
    pk = rng.integers(0, domain + 1, 500_000).astype(np.int32)
    got = ops.radix_hash_probe(_t(bk, dev), _t(pk, dev), domain)
    want = ops.radix_hash_probe(torch.from_numpy(bk), torch.from_numpy(pk),
                                domain)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_session_on_card_matches_cpu_and_launches_kernels(dev):
    """The main path on the card: same answers as the CPU engine, every
    kernel launched, one host sync and zero warm H2D bytes per fused
    query."""
    from repro_torch import device as D
    from repro_torch.core import Session, col

    rng = np.random.default_rng(11)
    n_o = 40_000
    orders = {"ok": (np.arange(n_o) * 3 + 1).astype(np.int64),
              "d": rng.integers(0, 2000, n_o).astype(np.int32)}
    li = {"ok": np.repeat(orders["ok"], rng.integers(1, 8, n_o)),
          }
    n_l = len(li["ok"])
    li["s"] = rng.integers(1, 500, n_l).astype(np.int64)
    li["p"] = rng.integers(0, 10**6, n_l).astype(np.int64)
    answers = {}
    D.reset_launch_counts()
    for name in ("cuda", "cpu"):
        sess = Session(work_mem=1 << 20, policy="tensor", device=name)
        sess.register("o", orders)
        sess.register("l", li)
        joined = (sess.table("l").join("o", on="ok")
                  .filter(col("b_d") < 900).sort("b_d", "ok"))
        qs = {"agg": joined.aggregate("p", "sum"),
              "rel": joined.select("ok", "b_d", "p"),
              "group": sess.table("l").group_by("s", {"p": "sum",
                                                      "ok": "count"}),
              "order": sess.table("o").filter(col("d") < 900).sort("d")}
        res = {k: q.collect() for k, q in qs.items()}
        warm = qs["agg"].collect()
        assert warm.total_host_syncs == 1 and warm.total_h2d_bytes == 0
        answers[name] = res
    counts = D.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    a, b = answers["cuda"], answers["cpu"]
    assert a["agg"].scalar == b["agg"].scalar
    assert a["rel"].relation.equals(b["rel"].relation)
    assert a["group"].relation.equals(b["group"].relation)
    assert a["order"].relation.equals(b["order"].relation)


_SORT_DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "uint16",
                "uint32", "uint64", "float16", "bfloat16", "float32",
                "float64"]


def _sort_keys(dtype, n, rng, shape="random"):
    """Keys of a dtype, made in numpy (floats in float64, with -0.0, NaN
    and infinities, cast at the end)."""
    if dtype == "bool":
        a = rng.integers(0, 2, n).astype(bool)
    elif dtype in ("float16", "bfloat16", "float32", "float64"):
        a = rng.normal(size=n) * 5
        if n > 16:
            a[::7] = 0.0
            a[1::11] = -0.0
            a[2::13] = np.nan
            a[3::17] = -np.inf
            a[4::19] = np.inf
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, n, endpoint=True,
                         dtype=np.int64 if info.min < 0 else np.uint64
                         ).astype(dtype)
    if shape == "equal" and n:
        a[:] = a[0]
    elif shape in ("sorted", "reversed"):
        a = np.sort(a)
        if shape == "reversed":
            a = a[::-1].copy()
    t = torch.from_numpy(a)
    return t.to(getattr(torch, dtype)) if a.dtype == np.float64 else t


@pytest.mark.parametrize("dtype", _SORT_DTYPES)
def test_radix_sort_pass_matches_plain_version(dev, dtype):
    """Every key dtype the engine sorts, at edge sizes (empty, one row, a
    tile and a row either side of it) and on equal, sorted and reverse
    sorted keys, with and without an incoming permutation."""
    from repro_torch import device as D
    from repro_torch.kernels.multikey_sort import kernel, ref

    rng = np.random.default_rng(17)
    D.reset_launch_counts()
    cases = [(n, "random") for n in (0, 1, 2047, 2048, 2049, 70_001)]
    cases += [(5000, s) for s in ("equal", "sorted", "reversed")]
    for n, shape in cases:
        col = _sort_keys(dtype, n, rng, shape).to(dev)
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for p in (None, perm):
            got = kernel.radix_sort_pass(col, p)
            assert torch.equal(got, ref.radix_sort_pass_ref(col, p)), \
                (n, shape, p is None)
    assert D.launch_counts()["radix_sort_pass"] == 2 * (len(cases) - 1)


def test_sort_perm_on_card_matches_plain_and_library(dev):
    """Several key columns and a validity mask: the kernel's permutation
    equals the plain version's and the torch.sort composition's."""
    from repro_torch.core.tensor_engine import _lex_perm, sort_perm_device
    from repro_torch.kernels.multikey_sort import ref

    rng = np.random.default_rng(23)
    n = 300_000
    cols = (_t(rng.integers(1, 5000, n), dev),
            _t(rng.integers(0, 2400, n).astype(np.int32), dev),
            _sort_keys("float64", n, rng).to(dev))
    valid = _t(rng.random(n) < 0.5, dev)
    for v in (None, valid):
        got = sort_perm_device(cols, v)
        assert torch.equal(got, ref.sort_perm_ref(cols, v))
        lib = _lex_perm(cols, n, dev)
        if v is not None:
            lib = lib[torch.sort((~v[lib]).to(torch.uint8),
                                 stable=True).indices]
        assert torch.equal(got, lib)


def test_radix_sort_pass_past_2_to_the_24_rows(dev):
    """Index arithmetic past int32 products: 2**24 + 4097 rows."""
    from repro_torch.kernels.multikey_sort import kernel

    rng = np.random.default_rng(29)
    n = (1 << 24) + 4097
    col = _t(rng.integers(-2**31, 2**31, n).astype(np.int32), dev)
    perm = torch.randperm(n, device=dev)
    got = kernel.radix_sort_pass(col, perm)
    want = perm[torch.sort(col[perm], stable=True).indices]
    assert torch.equal(got, want)


def test_query_server_on_card_matches_cpu(dev):
    """The closed loop on the card: every answer equals the CPU server's,
    no query fails, and the sort kernel runs under the serving threads."""
    from repro_torch import device as D
    from repro_torch.core import QueryServer, col

    rng = np.random.default_rng(31)
    n = 50_000
    tables = {"o": {"k": np.arange(n, dtype=np.int64),
                    "c": rng.integers(0, 900, n).astype(np.int64),
                    "d": rng.integers(0, 2000, n).astype(np.int32)},
              "l": {"k": rng.integers(0, n, 4 * n).astype(np.int64),
                    "p": rng.integers(0, 10**6, 4 * n).astype(np.int64)}}
    answers = {}
    for name in ("cuda", "cpu"):
        server = QueryServer(tables, total_mem=64 << 20, work_mem=1 << 20,
                             policy="tensor", device=name)
        s = server.session
        wl = [s.table("l").join("o", on="k").filter(col("b_d") < 900)
              .aggregate("p", "sum"),
              s.table("o").filter(col("d") < 1000).sort("c", "d")
              .select("k", "c", "d")]
        D.reset_launch_counts()
        rep = server.serve(wl, concurrency=4, queries_per_worker=3,
                           warmup=1)
        assert not rep.failed and rep.governor.over_budget_events == 0
        if name == "cuda":
            assert D.launch_counts()["radix_sort_pass"] > 0
        answers[name] = {q.workload_idx: (q.scalar, q.relation)
                         for q in rep.queries}
    for idx, (scalar, rel) in answers["cpu"].items():
        g_scalar, g_rel = answers["cuda"][idx]
        assert g_scalar == scalar
        assert (rel is None) or rel.equals(g_rel)
