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
    bit for bit (the plain version on the CPU sums each segment in row
    order, as the kernel does); out-of-range ids and codes included."""
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
    torch.testing.assert_close(
        kernel.segment_sum(seg, val, 512).cpu(),
        ref.segment_sum_ref(seg.cpu(), val.cpu(), 512), rtol=0, atol=0)


def _build_codes(case, n, dpad, rng):
    """Build-side codes of ``n`` rows into ``dpad`` slots (int32)."""
    if case == "random":
        return rng.integers(0, dpad, n)
    if case == "radix":   # ordered by 512-code block, 28% at one dead slot
        a = rng.integers(0, dpad - 1, n)
        a[n - n * 28 // 100:] = dpad - 1
        return a[np.argsort(a >> 9, kind="stable")]
    if case == "one_code":
        return np.full(n, 77)
    if case == "half_one_code":
        a = rng.integers(0, dpad, n)
        a[rng.permutation(n)[: n // 2]] = 5
        return a
    if case == "out_of_range":
        return rng.integers(-40, dpad + 40, n)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "radix", "one_code",
                                  "half_one_code", "out_of_range"])
@pytest.mark.parametrize("n", [1, 131, 300_001])
def test_join_table_build_matches_plain_version(dev, case, n):
    """Equal codes folded per lane and per warp before their atomics: the
    counts and largest rows equal the plain version's on any order."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(n)
    dpad = 4096
    bk = _t(_build_codes(case, n, dpad, rng).astype(np.int32), dev)
    brow = _t(rng.permutation(n).astype(np.int32), dev)
    got = kernel.join_table_build(bk, brow, dpad)
    want = ref.join_table_build_ref(bk, brow, dpad)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), case


def _segment_ids(case, n, rng):
    """Segment ids (int32) of ``n`` rows into 1000 segments, and whether
    each segment's rows are contiguous."""
    if case == "sorted":
        return np.sort(rng.integers(0, 1000, n)), True
    if case == "unsorted":
        return rng.integers(0, 1000, n), False
    if case == "out_of_range_sorted":
        return np.sort(rng.integers(-5, 1010, n)), True
    if case == "out_of_range":
        return rng.integers(-5, 1010, n), False
    if case == "half_in_one":   # one segment holds half the rows
        a = np.sort(rng.integers(0, 1000, n))
        a[n // 4: n // 4 + n // 2] = a[n // 4]
        return np.sort(a), True
    if case == "half_in_one_unsorted":
        a = rng.integers(0, 1000, n)
        a[rng.permutation(n)[: n // 2]] = 7
        return a, False
    if case == "runs_across_tiles":  # runs of 1..399 rows, then dropped ids
        a = np.repeat(np.arange(1000), rng.integers(1, 400, 1000))
        return np.concatenate([a, np.full(max(0, n - len(a)), 1003)])[:n], True
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "sorted", "unsorted", "out_of_range_sorted", "out_of_range",
    "half_in_one", "half_in_one_unsorted", "runs_across_tiles"])
@pytest.mark.parametrize("n", [1, 33, 200_001])
def test_segment_sum_sums_in_row_order(dev, case, n):
    """The card's float64 segment sum has the bits of the plain version on
    the CPU (each segment summed in ascending row order from +0.0, the
    reference's answer) for non-integer values, sorted ids (the GROUP BY's)
    and any others, ids out of range included, and the same bits on ten
    runs; one launch per call."""
    from repro_torch import device as D
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(n)
    ids, _ = _segment_ids(case, n, rng)
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)
    seg_c = torch.from_numpy(ids.astype(np.int32))
    val_c = torch.from_numpy(vals)
    want = ref.segment_sum_ref(seg_c, val_c, 1000)
    seg, val = seg_c.to(dev), val_c.to(dev)
    D.reset_launch_counts()
    runs = [kernel.segment_sum(seg, val, 1000).cpu() for _ in range(10)]
    assert D.launch_counts()["segment_sum"] == 10
    for got in runs:
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _sum_values(kind, n, rng):
    """float64 values of ``n`` rows: integer cents (Q-c's sums), counts,
    multiples of 2**-17 (all three exact in any order) or tenths (not)."""
    if kind == "cents":
        return rng.integers(90_000, 10_500_000, n).astype(np.float64)
    if kind == "counts":
        return rng.integers(0, 2, n).astype(np.float64)
    if kind == "pow2":
        return rng.integers(-2**20, 2**20, n) * 2.0**-17
    if kind == "tenths":
        return rng.integers(0, 10**6, n) / 10.0
    raise ValueError(kind)


def _expected_route(vals_cpu, ids):
    from repro_torch.kernels.segment_join import ref

    if ref.sum_is_order_free_ref(vals_cpu):
        return "exact"
    sorted_ids = len(ids) < 2 or bool(np.all(np.diff(ids) >= 0))
    return "runs" if sorted_ids else "grouped"


def _same_bits(got, want):
    """Equal float64 bits where the plain version is not NaN, NaN where it
    is (the card and the CPU may carry different NaN payloads)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int64), want[~nan].view(torch.int64))


@pytest.mark.parametrize("kind", ["cents", "counts", "pow2", "tenths"])
@pytest.mark.parametrize("case", [
    "sorted", "unsorted", "half_in_one", "half_in_one_unsorted",
    "out_of_range_sorted", "runs_across_tiles"])
@pytest.mark.parametrize("n", [33, 200_001])
def test_segment_sum_takes_the_exact_route_where_it_may(dev, kind, case, n):
    """Integer-valued columns (cents, counts, multiples of 2**-17) take the
    exact route, sorted ids or not; tenths take the row-order chain, over
    the ids as they come where they never decrease, else over the grouped
    copy.  The route is the plain predicate's, and every route gives the
    plain version's bits on three runs."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(n + len(case))
    ids, _ = _segment_ids(case, n, rng)
    seg_c = torch.from_numpy(ids.astype(np.int32))
    val_c = torch.from_numpy(_sum_values(kind, n, rng))
    want = ref.segment_sum_ref(seg_c, val_c, 1000)
    seg, val = seg_c.to(dev), val_c.to(dev)
    expected = _expected_route(val_c, ids)
    for _ in range(3):
        got, route = kernel.segment_sum_route(seg, val, 1000)
        assert route == expected, route
        _same_bits(got.cpu(), want)
    if kind != "tenths":
        assert expected == "exact"


@pytest.mark.parametrize("ids", ["sorted", "unsorted"])
def test_segment_sum_at_the_2_53_bound(dev, ids):
    """200,001 rows (ceil(log2 n) = 18) of integers below 2**35, one odd:
    exact; one value of 2**35 makes the bound 2**54 and the chain runs.
    The bits are the plain version's either way."""
    from repro_torch.kernels.segment_join import kernel, ref

    n = 200_001
    rng = np.random.default_rng(53)
    a = rng.integers(0, 300, n)
    a = np.sort(a) if ids == "sorted" else a
    under = rng.integers(2**34, 2**35, n).astype(np.float64)
    under[0] = 2.0**34 + 1
    past = under.copy()
    past[n // 2] = 2.0**35
    seg = _t(a.astype(np.int32), dev)
    for vals, route_if_exact in ((under, "exact"), (past, None)):
        val_c = torch.from_numpy(vals)
        got, route = kernel.segment_sum_route(seg, val_c.to(dev), 300)
        want = ref.segment_sum_ref(seg.cpu(), val_c, 300)
        _same_bits(got.cpu(), want)
        assert route == (route_if_exact
                         or ("runs" if ids == "sorted" else "grouped"))


@pytest.mark.parametrize("case", ["negative_zeros", "nan", "inf",
                                  "inf_minus_inf"])
def test_segment_sum_signed_zeros_nan_and_inf(dev, case):
    """All −0.0 is exact and sums to +0.0 (the row order's zero); a NaN or
    an infinity sends the call to the chain, whose NaNs and infinities
    fall where the plain version's do."""
    from repro_torch.kernels.segment_join import kernel, ref

    n = 50_000
    rng = np.random.default_rng(7)
    a = np.sort(rng.integers(0, 100, n)).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.float64)
    if case == "negative_zeros":
        vals[:] = -0.0
    elif case == "nan":
        vals[rng.permutation(n)[:5]] = np.nan
    elif case == "inf":
        vals[rng.permutation(n)[:5]] = np.inf
    else:
        vals[[10, 11]] = [np.inf, -np.inf]
    val_c = torch.from_numpy(vals)
    got, route = kernel.segment_sum_route(_t(a, dev), val_c.to(dev), 100)
    want = ref.segment_sum_ref(torch.from_numpy(a), val_c, 100)
    _same_bits(got.cpu(), want)
    assert route == ("exact" if case == "negative_zeros" else "runs")
    if case == "negative_zeros":
        assert not torch.signbit(got).any()


@pytest.mark.parametrize("ids", ["sorted", "unsorted",
                                 "contiguous_unordered"])
def test_segment_sum_picks_its_route_without_a_host_sync(dev, ids):
    """Non-integer values on ids that never decrease take the runs as they
    come; unsorted ids, and contiguous segments in no order, take the
    grouped copy.  Each gives the plain version's bits, and the call waits
    for nothing on the host (CUDA sync debug mode set to raise)."""
    from repro_torch.kernels.segment_join import kernel, ref

    n = 100_000
    rng = np.random.default_rng(19)
    if ids == "sorted":
        a = np.sort(rng.integers(0, 1000, n))
    elif ids == "unsorted":
        a = rng.integers(0, 1000, n)
    else:
        a = np.repeat(rng.permutation(1000), n // 1000)
    seg_c = torch.from_numpy(a.astype(np.int32))
    val_c = torch.from_numpy(rng.normal(size=len(a)))
    seg, val = seg_c.to(dev), val_c.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel.segment_sum(seg, val, 1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = ref.segment_sum_ref(seg_c, val_c, 1000)
    _same_bits(got.cpu(), want)
    _, route = kernel.segment_sum_route(seg, val, 1000)
    assert route == ("runs" if ids == "sorted" else "grouped")


def test_radix_rank_past_shared_memory(dev):
    """More buckets than a block's shared memory holds (400 KB of int32
    counts): three digit passes, and the ranks must still be stable."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(8)
    nb = 100_000  # 400 KB of int32 per tile row
    ids = _t(rng.integers(0, nb, 70_000).astype(np.int32), dev)
    for g, w in zip(kernel.radix_rank(ids, nb), ref.radix_rank_ref(ids, nb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,nb,ids", [
    (2_097_152, 16_385, "sorted"),    # the join's build side
    (2_097_152, 16_385, "random"),
    (300_000, 16_385, "out_of_range"),
    (1, 16_385, "random"),
    (2049, 16_385, "random"),         # one row past a tile
    (2049, 100_000, "out_of_range"),
    (50_000, 256, "random"),          # a key of 9 bits: two passes
    (50_000, 1, "out_of_range"),
])
def test_radix_rank_matches_plain_version_bit_for_bit(dev, n, nb, ids):
    """The rank kernel against its plain version at the main path's bucket
    count, past a tile, with ids outside ``[0, nb)``, and at bucket counts
    on either side of a digit; one launch per call."""
    from repro_torch import device as D
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(n + nb)
    if ids == "out_of_range":
        a = rng.integers(-3, nb + 5, n)
    else:
        a = rng.integers(0, nb, n)
        if ids == "sorted":
            a = np.sort(a)
    t = _t(a.astype(np.int32), dev)
    D.reset_launch_counts()
    got = kernel.radix_rank(t, nb)
    assert D.launch_counts()["radix_rank"] == 1
    for g, w in zip(got, ref.radix_rank_ref(t, nb)):
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


@pytest.mark.parametrize("layout", ["pairs", "separate"])
@pytest.mark.parametrize("order", ["ordered", "shuffled", "out_of_range",
                                   "unaligned"])
@pytest.mark.parametrize("n", [1, 7, 300_001])
def test_join_table_probe_reads_either_table_layout(dev, layout, order, n):
    """The probe reads the build's interleaved (cnt, inv) table with one
    8-byte gather a probe, or two separate tables; probes in order, in no
    order, outside the table, and from a pointer 4 bytes past alignment
    (scalar loads); both entries (the count and inv, and the row-order
    ``inv - 1``) equal their plain versions."""
    from repro_torch.kernels.segment_join import kernel, ref

    rng = np.random.default_rng(n)
    dpad = 4096
    bk = _t(rng.integers(0, dpad // 2, 20_000).astype(np.int32), dev)
    brow = torch.arange(20_000, dtype=torch.int32, device=dev)
    if layout == "pairs":
        cnt, inv = kernel.join_table_build(bk, brow, dpad)
        assert cnt.stride(0) == 2 and inv.data_ptr() == cnt.data_ptr() + 4
    else:
        cnt, inv = (t.to(dev) for t in
                    ref.join_table_build_ref(bk.cpu(), brow.cpu(), dpad))
    if order == "ordered":
        codes = np.sort(rng.integers(0, dpad, n))
    elif order == "out_of_range":
        codes = rng.integers(-50, dpad + 50, n)
    else:
        codes = rng.integers(0, dpad, n + (order == "unaligned"))
    pk = _t(codes.astype(np.int32), dev)
    if order == "unaligned":
        pk = pk[1:]
        assert pk.data_ptr() % 16 == 4
    for fn, plain in ((kernel.join_table_probe, ref.join_table_probe_ref),
                      (kernel.join_table_probe_rows,
                       ref.join_table_probe_rows_ref)):
        got = fn(pk, cnt, inv)
        want = plain(pk.cpu(), cnt.cpu(), inv.cpu())
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__


@pytest.mark.parametrize("order", ["in_order", "shuffled", "dead_slot"])
def test_radix_hash_probe_on_card_in_any_probe_order(dev, order):
    """The whole probe on the card equals the CPU's plain composition with
    the probe codes in order (as lineitem's come), shuffled, and all at
    the dead slot; the probe side costs one launch (no radix_rank of its
    own)."""
    from repro_torch import device as D
    from repro_torch.kernels.segment_join import ops

    rng = np.random.default_rng(29)
    domain = 1 << 20
    bk = rng.permutation(domain)[:300_000].astype(np.int32)
    bk[:1000] = domain
    pk = rng.integers(0, domain + 1, 500_000)
    pk = {"in_order": np.sort(pk), "shuffled": pk,
          "dead_slot": np.full_like(pk, domain)}[order].astype(np.int32)
    D.reset_launch_counts()
    got = ops.radix_hash_probe(_t(bk, dev), _t(pk, dev), domain)
    counts = D.launch_counts()
    assert (counts["radix_rank"], counts["join_table_build"],
            counts["join_table_probe"]) == (1, 1, 1)
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
    assert all(counts[k] > 0 for k in D.RELATIONAL_KERNELS), counts
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


def _digit_case(case, n, rng):
    """Columns whose order bits vary in chosen digits only."""
    if case == "all_equal":
        return torch.full((n,), -123456789, dtype=torch.int64)
    if case == "top_digit":
        return torch.from_numpy(rng.integers(0, 100, n) << 56)
    if case == "low_digit":
        return torch.from_numpy((1234 << 8) + rng.integers(0, 256, n))
    if case == "negative_only":   # raw top byte 0xff, 0x7f after the flip
        return torch.from_numpy(-rng.integers(1, 1 << 20, n))
    if case == "positive_only":   # raw top byte 0x00, 0x80 after the flip
        return torch.from_numpy(rng.integers(0, 1 << 20, n))
    if case == "mixed_sign":      # every digit varies
        return torch.from_numpy(rng.integers(-1000, 1000, n))
    if case == "o_custkey":
        return torch.from_numpy(rng.integers(1, 150_001, n))
    if case == "o_orderdate":
        return torch.from_numpy(rng.integers(8035, 10_441, n).astype(np.int32))
    if case == "signed_zeros":    # one key after -0.0 -> +0.0
        return torch.from_numpy(rng.choice([0.0, -0.0], n))
    if case == "nans":            # one key after NaN -> one quiet NaN
        bits = rng.choice(np.array([0x7FC00000, 0xFFC00000, 0x7F800001,
                                    0xFF812345], dtype=np.uint32), n)
        return torch.from_numpy(bits.view(np.float32))
    if case == "zeros_and_nans":
        a = rng.choice([0.0, -0.0, np.nan, -np.nan], n).astype(np.float32)
        return torch.from_numpy(a)
    raise ValueError(case)


@pytest.mark.parametrize("case,mask", [
    ("all_equal", 0), ("top_digit", 0x80), ("low_digit", 0x01),
    ("negative_only", 0x07), ("positive_only", 0x07), ("mixed_sign", 0xFF),
    ("o_custkey", 0x07), ("o_orderdate", 0x03), ("signed_zeros", 0),
    ("nans", 0), ("zeros_and_nans", 0x0C),
])
@pytest.mark.parametrize("with_perm", [False, True])
def test_radix_sort_pass_runs_only_varying_digits(dev, case, mask,
                                                  with_perm):
    """The pass sorts on the digits in which the keys differ and skips the
    rest: the permutation equals the plain version's, and the passes that
    ran are the digits :func:`digit_mask_ref` names."""
    from repro_torch import device as D
    from repro_torch.kernels.multikey_sort import kernel, ref

    rng = np.random.default_rng(37)
    n = 70_001
    col = _digit_case(case, n, rng).to(dev)
    perm = (torch.from_numpy(rng.permutation(n)).to(dev) if with_perm
            else None)
    assert ref.digit_mask_ref(col) == mask
    D.reset_launch_counts()
    got, ran = kernel.digit_passes_run(col, perm)
    assert D.launch_counts()["radix_sort_pass"] == 1
    assert ran == mask
    assert torch.equal(got, ref.radix_sort_pass_ref(col, perm))


def test_device_sort_waits_for_no_host_sync(dev):
    """Which digits run is decided on the device: the sort of a Q-d-style
    ORDER BY makes no synchronising torch call, and the query keeps its one
    host sync (the final fetch)."""
    from repro_torch.core import Session, col
    from repro_torch.core.tensor_engine import sort_perm_device
    from repro_torch.kernels.multikey_sort import ref

    rng = np.random.default_rng(41)
    n = 100_000
    orders = {"orderkey": np.arange(n, dtype=np.int64),
              "o_custkey": rng.integers(1, 150_001, n),
              "o_orderdate": rng.integers(8035, 10_441, n).astype(np.int32)}
    cols = (_t(orders["o_custkey"], dev), _t(orders["o_orderdate"], dev))
    valid = cols[1] < 9204
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sort_perm_device(cols, valid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, ref.sort_perm_ref(cols, valid))
    sess = Session(work_mem=1 << 20, policy="tensor", device="cuda")
    sess.register("orders", orders)
    q = (sess.table("orders").filter(col("o_orderdate") < 9204)
         .sort("o_custkey", "o_orderdate")
         .select("orderkey", "o_custkey", "o_orderdate"))
    for _ in range(2):
        res = q.collect()
        assert res.total_host_syncs == 1
        assert "sort" in [m.op for m in res.metrics]


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


@pytest.mark.parametrize("agg", [("w", "sum"), ("b_i32", "sum"),
                                 ("b_u32", "sum"), ("b_u64", "sum"),
                                 ("b_u32", "max"), ("b_u16", "min"),
                                 ("b_f", "max"), ("w", "count")])
def test_sharded_fragment_on_card_matches_cpu(dev, agg):
    """The sharded fragment over eight lanes on the card: the CPU's float
    and counters (integer sums past 2^31 and 2^32 included; CUDA has no
    ``where`` or comparison for uint16/32/64), one host sync, and a warm
    run that uploads nothing."""
    from repro_torch.core import FusedSpec, Relation, col, run_fused

    rng = np.random.default_rng(41)
    n_b, n_p = 40_000, 60_000
    build = {"k": rng.permutation(n_b).astype(np.int64) * 7919 + 3,
             "i32": rng.integers(1 << 20, (1 << 31) - 1, n_b,
                                 dtype=np.int64).astype(np.int32),
             "u32": rng.integers(1 << 30, 1 << 32, n_b,
                                 dtype=np.uint64).astype(np.uint32),
             "u64": rng.integers(1 << 60, 1 << 62, n_b, dtype=np.uint64),
             "u16": rng.integers(0, 1 << 16, n_b).astype(np.uint16),
             "f": rng.normal(size=n_b)}
    probe = {"k": build["k"][rng.integers(0, n_b, n_p)],
             "w": rng.integers(-100, 100, n_p).astype(np.int64)}
    spec = FusedSpec("k", col("w") < 50, (), agg)
    out = {}
    for name in ("cuda", "cpu"):
        b, p = Relation(dict(build)), Relation(dict(probe))
        runs = [run_fused(spec, b, p, shards=8, device=name)
                for _ in range(2)]
        for _, m in runs:
            assert m.devices == 8 and m.host_syncs == 1
        assert runs[1][1].h2d_bytes == 0
        out[name] = [(r, m.h2d_bytes, m.h2d_bytes_logical,
                      m.peak_working_set_bytes) for r, m in runs]
    assert out["cuda"] == out["cpu"]


def test_fused_sort_on_unsigned_keys_on_card_matches_cpu(dev):
    """uint32 and uint64 sort keys in the fused fragment: the card gives
    the CPU's rows (CUDA has no gather or ``where`` for these dtypes, so
    the keys are mapped to signed ones of the same order first)."""
    from repro_torch.core import Session, col

    rng = np.random.default_rng(2)
    n_b, n_p = 500, 2000
    u64 = rng.integers(0, 1 << 62, 40, dtype=np.uint64) * np.uint64(4)
    u64[::2] |= np.uint64(1 << 63)
    build = {"k": np.arange(n_b, dtype=np.int64),
             "u32": rng.integers(0, 1 << 32, n_b,
                                 dtype=np.uint64).astype(np.uint32),
             "u64": rng.choice(u64, n_b)}
    probe = {"k": rng.integers(0, n_b + 20, n_p).astype(np.int64),
             "w": rng.integers(-50, 50, n_p).astype(np.int64)}
    out = {}
    for name in ("cuda", "cpu"):
        sess = Session(work_mem=1 << 20, policy="tensor", device=name)
        sess.register("p", probe)
        sess.register("b", build)
        res = (sess.table("p").join("b", on="k").filter(col("w") > 0)
               .sort("b_u64", "b_u32", "w").collect())
        assert [m.op for m in res.metrics] == ["fused_pipeline"], name
        out[name] = res.relation
    assert out["cuda"].equals(out["cpu"])


# ---------------------------------------------------------------------------
# the LM path: flash attention, MoE dispatch/combine, prefill
# ---------------------------------------------------------------------------

def _attn_inputs(B, Sq, Sk, H, KH, D, Dv, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        device=dev, dtype=dtype)
        for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, Dv))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,kw", [
    ((2, 200, 200, 8, 2, 64, 64), {}),                      # ragged tiles
    ((1, 96, 96, 4, 4, 128, 96), {"window": 40}),           # D != Dv
    ((1, 64, 160, 8, 1, 256, 256), {"q_offset": 96,
                                     "cap": 50.0}),          # Gemma-2 dims
    ((2, 130, 130, 4, 2, 32, 32), {"causal": False, "window": 17}),
])
def test_flash_attention_matches_plain_version(dev, dtype, tol, shape, kw):
    """bfloat16 launches the wgmma kernel, float32 the 3xTF32 kernel; each
    once, the other never."""
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention import kernel, ref

    B, Sq, Sk, H, KH, Dh, Dv = shape
    q, k, v = _attn_inputs(B, Sq, Sk, H, KH, Dh, Dv, dtype, dev)
    kw = dict({"causal": True}, **kw)
    D.reset_launch_counts()
    got = kernel.flash_attention_fwd(q, k, v, scale=Dh ** -0.5, **kw)
    torch.cuda.synchronize()
    counts = D.launch_counts()
    mine, other = (("flash_attention", "flash_attention_f32")
                   if dtype == torch.bfloat16
                   else ("flash_attention_f32", "flash_attention"))
    assert (counts[mine], counts[other]) == (1, 0), counts
    want = ref.flash_attention_ref(q, k, v, scale=Dh ** -0.5, **kw)
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# the tensor-core kernels' cases: Sq != Sk, padded D and Dv, Gemma-2's
# window and soft-cap, rows with no visible key, H/KH = 8, ragged tiles,
# D 192, 16 and 256, and DeepSeek-V2-Lite's MLA widths (q/k 192, v 128, no
# grouping)
_TENSOR_CORE_CASES = [
    ((1, 200, 333, 16, 2, 128, 128), {"q_offset": 133}),      # Sq != Sk
    ((1, 300, 300, 4, 2, 80, 96), {}),                       # padded D, Dv
    ((1, 1024, 1024, 16, 8, 256, 256), {"window": 512,
                                        "cap": 50.0}),       # Gemma-2
    ((1, 64, 100, 2, 1, 64, 64), {"causal": False, "window": 10,
                                  "q_offset": 150}),         # no key: mean V
    ((2, 256, 256, 32, 4, 128, 128), {}),                    # H/KH = 8
    ((2, 77, 211, 8, 2, 64, 64), {"q_offset": 134}),         # ragged tiles
    ((1, 130, 257, 4, 2, 192, 192), {"window": 100}),        # 3 D tiles
    ((1, 70, 70, 2, 1, 16, 16), {}),                         # D = 16
    ((1, 100, 100, 4, 4, 256, 64), {"causal": False}),       # D 256, Dv 64
    ((2, 300, 300, 16, 16, 192, 128), {}),                   # MLA: 192/128
]


# bf16 on the tensor-core kernel: each output within 2e-3 + 2^-6 * |plain|,
# two bf16 steps of its own size (as chip_smoke.py holds the main shape)
@pytest.mark.parametrize("shape,kw", _TENSOR_CORE_CASES)
def test_flash_attention_bf16_tensor_core_cases(dev, shape, kw):
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention import kernel, ref

    B, Sq, Sk, H, KH, Dh, Dv = shape
    q, k, v = _attn_inputs(B, Sq, Sk, H, KH, Dh, Dv, torch.bfloat16, dev,
                           seed=Sq)
    kw = dict({"causal": True, "scale": Dh ** -0.5}, **kw)
    D.reset_launch_counts()
    got = kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert D.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == (B, Sq, H, Dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -6,
                               atol=2e-3)


# float32 on the 3xTF32 kernel, within the reference's float32 tolerance
# (2e-5), over the same cases and three decode steps (one query row per
# sequence, G = 4, 8 and 2 query heads on each kv head)
@pytest.mark.parametrize("shape,kw", _TENSOR_CORE_CASES + [
    ((4, 1, 300, 32, 8, 128, 128), {"q_offset": 299}),          # G 4
    ((2, 1, 500, 32, 4, 128, 128), {"q_offset": 499}),          # G 8
    ((2, 1, 257, 16, 8, 256, 256), {"q_offset": 256, "window": 100,
                                    "cap": 50.0}),              # G 2
])
def test_flash_attention_f32_tensor_core_cases(dev, shape, kw):
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention import kernel, ref

    B, Sq, Sk, H, KH, Dh, Dv = shape
    q, k, v = _attn_inputs(B, Sq, Sk, H, KH, Dh, Dv, torch.float32, dev,
                           seed=Sq + Sk)
    kw = dict({"causal": True, "scale": Dh ** -0.5}, **kw)
    D.reset_launch_counts()
    got = kernel.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert D.launch_counts()["flash_attention_f32"] == 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, Dv)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_reads_strided_views(dev):
    """q sliced from a fused ``[B, S, H+1, D]`` projection and k/v as
    transposes of ``[B, KH, S, D]`` go through TMA by their strides: the
    output equals the contiguous copies' bit for bit, and the plain
    version's within the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import kernel, ref

    B, S, H, KH, Dh = 2, 150, 8, 2, 64
    rng = np.random.default_rng(4)
    fused = torch.from_numpy(rng.normal(size=(B, S, H + 1, Dh)).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16)
    q = fused[:, :, 1:]
    k, v = (torch.from_numpy(rng.normal(size=(B, KH, S, Dh)).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16).transpose(1, 2)
        for _ in range(2))
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    assert kernel.select_kernel(q, k, v) == "flash_attention"
    kw = dict(causal=True, window=70, scale=Dh ** -0.5)
    got = kernel.flash_attention_fwd(q, k, v, **kw)
    same = kernel.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), **kw)
    torch.testing.assert_close(got, same, rtol=0.0, atol=0.0)
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v, **kw).float(),
                               rtol=2.0 ** -6, atol=2e-3)


def test_flash_attention_reads_strided_views(dev):
    """Views go into the kernel through their strides, without a copy: q
    as a slice of a fused projection, k and v as transposes of ``[B, KH,
    S, D]``, give the same output as their contiguous copies."""
    from repro_torch.kernels.flash_attention import ops

    B, S, H, KH, Dh = 2, 150, 8, 2, 64
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.normal(size=(B, S, H + 1, Dh)).astype(
        np.float32)).to(dev)
    q = fused[:, :, 1:]
    k, v = (torch.from_numpy(rng.normal(size=(B, KH, S, Dh)).astype(
        np.float32)).to(dev).transpose(1, 2) for _ in range(2))
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = ops.flash_attention(q, k, v, causal=True, window=70)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=70)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 0.0),
                                       (torch.bfloat16, 0.0)])
def test_moe_dispatch_and_combine_match_plain_versions(dev, dtype, tol):
    """Duplicate, negative and overflowing slots included: both kernels
    sum in float32 in token order, as the plain versions do, so they agree
    exactly."""
    from repro_torch.kernels.moe_dispatch import kernel, ref

    rng = np.random.default_rng(9)
    T, d, E, C = 3000, 520, 8, 300
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32)).to(
        device=dev, dtype=dtype)
    e = _t(rng.integers(-1, E + 1, T).astype(np.int32), dev)
    s = _t(rng.integers(-2, C + C // 4, T).astype(np.int32), dev)
    w = _t(rng.random(T).astype(np.float32), dev)
    buf = kernel.moe_dispatch(x, e, s, E, C)
    torch.testing.assert_close(buf, ref.dispatch_ref(x, e, s, E, C),
                               rtol=tol, atol=tol)
    y = kernel.moe_combine(buf, e, s, w)
    torch.testing.assert_close(y, ref.combine_ref(buf, e, s, w), rtol=tol,
                               atol=tol)


def _routing_views(T, E, C, rng, dev):
    """Columns of a ``[T, 2]`` routing as the layer body hands them over:
    int64 expert ids and int32 slots, strided views, some out of range."""
    e = _t(rng.integers(-1, E + 1, (T, 2)).astype(np.int64), dev)
    s = _t(rng.integers(-1, C + C // 4 + 1, (T, 2)).astype(np.int32), dev)
    return e, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,E,C", [(4, 4096, 16, 16),    # a decode step
                                     (3000, 520, 8, 300),  # past the scan
                                     (257, 136, 4, 80)])
def test_moe_dispatch_reads_routing_views_and_adds_into(dev, dtype, T, d, E,
                                                        C):
    """The dispatch takes the routing's int64 and int32 column views as
    they come, and adds a second slot into the first slot's buffer with the
    rounding of ``buf + b``: both exact against the plain version."""
    from repro_torch import device as D
    from repro_torch.kernels.moe_dispatch import kernel, ref

    rng = np.random.default_rng(T + d)
    x = _t(rng.normal(size=(T, d)).astype(np.float32), dev).to(dtype)
    e, s = _routing_views(T, E, C, rng, dev)
    assert not e[:, 0].is_contiguous() and e.dtype == torch.int64
    D.reset_launch_counts()
    buf = kernel.moe_dispatch(x, e[:, 0], s[:, 0], E, C)
    want = ref.dispatch_ref(x, e[:, 0], s[:, 0], E, C)
    assert torch.equal(buf, want)
    got = kernel.moe_dispatch(x, e[:, 1], s[:, 1], E, C, into=buf)
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(got, want + ref.dispatch_ref(x, e[:, 1], s[:, 1], E,
                                                    C))
    assert D.launch_counts()["moe_dispatch"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_workspace_across_shrinking_and_growing_calls(dev,
                                                                  dtype):
    """Past the scan limit the dispatch keeps a workspace that only grows;
    calls at E*C rows of 3200, then 1600, then 3200 again, on one stream,
    each exact in the layer body's form (slot 0, then slot 1 added in).
    Token 1 goes to expert 1 in the smaller call, so that a token the
    smaller call leaves in the workspace would land where the larger call
    reads an empty row's count."""
    from repro_torch.kernels.moe_dispatch import kernel, ops, ref

    rng = np.random.default_rng(31)
    T, d, E = 300, 136, 8
    x = _t(rng.normal(size=(T, d)).astype(np.float32), dev).to(dtype)
    for C in (400, 200, 400):
        first = rng.integers(0, E, T)
        idx = np.stack([first, (first + rng.integers(1, E, T)) % E], 1)
        idx[1] = (1, 2)
        topk = _t(idx.astype(np.int64), dev)
        slot = ops.expert_slots(topk, E)
        buf = kernel.moe_dispatch(x, topk[:, 0], slot[:, 0], E, C)
        want = ref.dispatch_ref(x, topk[:, 0], slot[:, 0], E, C)
        assert torch.equal(buf, want), C
        got = kernel.moe_dispatch(x, topk[:, 1], slot[:, 1], E, C, into=buf)
        assert torch.equal(got, want + ref.dispatch_ref(
            x, topk[:, 1], slot[:, 1], E, C)), C


@pytest.mark.parametrize("T,kernels", [(4, 1), (8192, 2)])
def test_moe_dispatch_launch_count_per_call(dev, T, kernels):
    """One dispatch call launches one kernel at the decode shape and two at
    the prefill's, and no memset or copy (the profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.moe_dispatch import kernel

    rng = np.random.default_rng(T)
    E, d = 16, 4096
    C = max(16, T * 2 * 5 // (4 * E))
    x = _t(rng.normal(size=(T, d)).astype(np.float32), dev).to(
        torch.bfloat16)
    e, s = _routing_views(T, E, C, rng, dev)
    kernel.moe_dispatch(x, e[:, 0], s[:, 0], E, C)  # workspace made here
    torch.cuda.synchronize()
    # a session that came back without device events is taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kernel.moe_dispatch(x, e[:, 0], s[:, 0], E, C)
            torch.cuda.synchronize()
        device_events = [ev.name for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA]
        if device_events:
            break
    assert len(device_events) == kernels, device_events
    assert all("dispatch" in name for name in device_events), device_events


def _combine_case(T, d, E, C, k, dtype, dev, seed):
    """buf and a ``[T, k]`` routing as the layer hands it over: int64
    expert ids and int32 slots as strided column views (some dropped or
    overflowing), float32 weights as a column slice."""
    rng = np.random.default_rng(seed)
    buf = _t(rng.normal(size=(E, C, d)).astype(np.float32), dev).to(dtype)
    idx = _t(rng.integers(-1, E + 1, (T, k + 2)).astype(np.int64),
             dev)[:, :k]
    slot = _t(rng.integers(-1, C + C // 4 + 1, (T, 2 * k)).astype(np.int32),
              dev)[:, ::2]
    w = _t(rng.random((T, k + 1)).astype(np.float32), dev)[:, 1:]
    return buf, idx, slot, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 6])
@pytest.mark.parametrize("T,d,E,C", [(4, 4096, 16, 16),       # decode
                                     (8192, 4096, 16, 1280),  # prefill
                                     (8192, 2048, 64, 960),   # DeepSeek
                                     (37, 100, 4, 16),        # scalar tail
                                     (300, 132, 8, 48)])
def test_moe_combine_slots_matches_plain_versions(dev, dtype, k, T, d, E, C):
    """All k slots in one launch: bit for bit the plain version (the loop
    of ``combine_ref`` and ``y + c``) and the earlier composition of k
    single-slot kernels and adds, strided routing views included."""
    from repro_torch.kernels.moe_dispatch import kernel, ref

    buf, idx, slot, w = _combine_case(T, d, E, C, k, dtype, dev, T + k)
    assert not (idx.is_contiguous() or slot.is_contiguous()
                or w.is_contiguous())
    got = kernel.moe_combine_slots(buf, idx, slot, w)
    assert torch.equal(got, ref.combine_slots_ref(buf, idx, slot, w))
    two_call = None
    for j in range(k):
        c = kernel.moe_combine(buf, idx[:, j], slot[:, j], w[:, j])
        assert torch.equal(c, ref.combine_ref(buf, idx[:, j], slot[:, j],
                                              w[:, j]))
        two_call = c if two_call is None else two_call + c
    assert torch.equal(got, two_call)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_slots_on_unaligned_buf(dev, dtype):
    """A buf that is not 16-byte aligned takes the scalar columns."""
    from repro_torch.kernels.moe_dispatch import kernel, ref

    E, C, d, T, k = 4, 16, 256, 40, 2
    buf0, idx, slot, w = _combine_case(T, d, E, C, k, dtype, dev, 5)
    flat = torch.empty(E * C * d + 1, dtype=dtype, device=dev)
    buf = flat[1:].view(E, C, d)
    buf.copy_(buf0)
    assert buf.data_ptr() % 16 != 0
    assert torch.equal(kernel.moe_combine_slots(buf, idx, slot, w),
                       ref.combine_slots_ref(buf, idx, slot, w))


def test_moe_ops_take_narrow_integer_ids(dev):
    """``ops`` converts int8/uint8/int16 ids to int32 before the launch and
    other weights to float32, so the card takes what the CPU takes: equal
    bit for bit to the int64/float32 call and to the plain version."""
    from repro_torch.kernels.moe_dispatch import ops, ref

    T, d, E, C, k = 40, 256, 4, 16, 2
    buf, idx, slot, w = _combine_case(T, d, E, C, k, torch.bfloat16, dev, 9)
    idx, slot = idx.clamp(min=0), slot.clamp(min=0)
    got = ops.combine_slots(buf, idx.to(torch.uint8), slot.to(torch.int16),
                            w.double())
    assert torch.equal(got, ops.combine_slots(buf, idx, slot, w))
    assert torch.equal(got, ref.combine_slots_ref(buf, idx, slot, w))
    assert torch.equal(ops.combine(buf, idx[:, 0].to(torch.int8),
                                   slot[:, 0].to(torch.int8), w[:, 0]),
                       ref.combine_ref(buf, idx[:, 0], slot[:, 0], w[:, 0]))
    x = buf.reshape(-1, d)[:T]
    assert torch.equal(ops.dispatch(x, idx[:, 1].to(torch.int16),
                                    slot[:, 1].to(torch.uint8), E, C),
                       ref.dispatch_ref(x, idx[:, 1], slot[:, 1], E, C))


def test_moe_layer_combine_is_one_launch(dev):
    """The layer body at the decode shape: ``moe_combine`` rises by one a
    call, and ``ops.combine_slots`` launches that kernel alone (no
    conversion, copy or add; the profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import device as D
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.models.moe import _route, capacity_per_expert

    cfg = get_config("phi3.5-moe-42b-a6.6b")
    T, d, E, k = 4, cfg.d_model, cfg.num_experts, cfg.experts_per_token
    C = capacity_per_expert(T, E, k, cfg.capacity_factor)
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(T, d)).astype(np.float32), dev).to(
        torch.bfloat16)
    router = _t(rng.normal(size=(d, E)).astype(np.float32), dev) / d ** 0.5
    idx, w, _ = _route({"router": router}, x, cfg)
    D.reset_launch_counts()
    for calls in (1, 2, 3):
        ops.moe_dispatch(None, x, idx, w, cfg, C, lambda p, b, c: b)
        assert D.launch_counts()["moe_combine"] == calls
    slot = ops.expert_slots(idx, E)
    buf = torch.randn((E, C, d), device=dev).to(torch.bfloat16)
    ops.combine_slots(buf, idx, slot, w)
    torch.cuda.synchronize()
    calls = 3
    # the card's profiler now and then returns a session that lost its
    # device events: such a trace, with fewer events than calls, is taken
    # again (five traces at most)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the trace may drop its first kernel (while it asks for its
            # activity buffer): a fill goes first
            torch.zeros(1, device=dev)
            for _ in range(calls):
                ops.combine_slots(buf, idx, slot, w)
            torch.cuda.synchronize()
        device_events = [ev.name for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA]
        if len(device_events) >= calls:
            break
    combines = [name for name in device_events if "combine" in name]
    assert len(combines) == calls, device_events
    assert len(device_events) - len(combines) <= 1, device_events


def test_group_by_hands_the_card_sorted_ids(dev, monkeypatch):
    """The GROUP BY on the card passes ids that never decrease (so the
    card never sends it to the grouped route), and its relation equals the
    CPU's."""
    from repro_torch.core import Session, tensor_engine

    calls = []
    real = tensor_engine.segment_sum_dispatch

    def spy(values, seg_ids, num_segments):
        calls.append((seg_ids.device.type,
                      bool((seg_ids[1:] >= seg_ids[:-1]).all())))
        return real(values, seg_ids, num_segments)

    monkeypatch.setattr(tensor_engine, "segment_sum_dispatch", spy)
    rng = np.random.default_rng(47)
    n = 50_000
    table = {"g": rng.integers(0, 900, n).astype(np.int64),
             "w": rng.normal(size=n), "c": rng.integers(0, 9, n)}
    out = {}
    for device in ("cuda", "cpu"):
        sess = Session(work_mem=1 << 20, policy="tensor", device=device)
        sess.register("t", table)
        res = sess.table("t").group_by("g", {"w": "sum",
                                             "c": "count"}).collect()
        out[device] = res.relation
    cuda_calls = [inc for d, inc in calls if d == "cuda"]
    assert cuda_calls and all(cuda_calls)
    assert out["cuda"].equals(out["cpu"])


def test_unsigned_aggregates_on_card_match_cpu(dev):
    """GROUP BY sum, count, min and max over uint32 and uint64 columns:
    the card gives the CPU's relation, bit for bit."""
    from repro_torch.core import Session

    rng = np.random.default_rng(43)
    n = 60_000
    table = {"g": rng.integers(0, 700, n).astype(np.int64),
             "u32": rng.integers(0, 1 << 32, n,
                                 dtype=np.uint64).astype(np.uint32),
             "u64": rng.integers(0, 1 << 63, n, dtype=np.uint64)
             * np.uint64(2) + np.uint64(1)}
    out = {}
    for name in ("cuda", "cpu"):
        sess = Session(work_mem=1 << 20, policy="tensor", device=name)
        sess.register("t", table)
        out[name] = {fn: sess.table("t").group_by(
            "g", {"u32": fn, "u64": fn}).collect().relation
            for fn in ("sum", "count", "min", "max")}
    for fn in out["cpu"]:
        assert out["cuda"][fn].equals(out["cpu"][fn]), fn


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "yi-9b",
                                  "gemma2-9b", "deepseek-v2-lite-16b",
                                  "mamba2-370m", "jamba-1.5-large-398b"])
def test_smoke_prefill_and_generate_on_card_match_cpu(dev, arch):
    """The same weights on the card and on the CPU: prefill logits within
    2e-4 (float32; matmuls in full float32), generate's tokens equal, and
    the LM kernels launched."""
    from repro_torch import device as D
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.serving.engine import generate, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params_cpu = init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    params = _tree_to(params_cpu, dev)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    out = {}
    D.reset_launch_counts()
    for where, p in (("cuda", params), ("cpu", params_cpu)):
        batch = {"tokens": torch.from_numpy(toks).to(where)}
        logits, _ = make_prefill_step(cfg)(p, batch)
        out[where] = (logits.cpu(), generate(p, cfg, toks[:, :8], 6))
    counts = D.launch_counts()
    if cfg.uses_attention:  # float32: the 3xTF32 kernel
        assert counts["flash_attention_f32"] > 0
    if cfg.uses_moe:
        assert counts["moe_dispatch"] > 0 and counts["moe_combine"] > 0
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


def _tree_to(tree, dev):
    return {k: (_tree_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# training: the backward kernels and gradients on the card
# ---------------------------------------------------------------------------

#: (B, Sq, Sk, H, KH, D, Dv, causal, window, cap, q_offset)
_BWD_CASES = [
    (2, 64, 64, 4, 2, 16, 16, True, None, None, 0),
    (2, 100, 70, 8, 2, 64, 64, True, None, None, 30),
    (1, 77, 130, 4, 4, 192, 128, True, None, None, 53),    # MLA's widths
    (2, 96, 48, 8, 2, 32, 32, True, 9, 30.0, 20),          # rows see no key
    (2, 80, 90, 4, 1, 128, 128, False, 7, None, 3),
    (1, 64, 40, 4, 2, 256, 256, False, None, 50.0, 0),
    (2, 256, 256, 32, 8, 128, 128, True, None, None, 0),   # Phi's heads
    # widths and lengths that the m16n8k8 fragments and the tiles do not
    # divide: D, Dv not multiples of 8, Sq, Sk not multiples of 16
    (2, 75, 53, 6, 3, 20, 12, True, 17, 20.0, 9),
    (1, 37, 141, 4, 2, 20, 12, False, 25, 30.0, 40),
    (2, 50, 29, 4, 2, 12, 20, True, 6, None, 27),          # rows see no key
    (1, 133, 131, 6, 2, 44, 36, True, 50, 15.0, 5),
    (1, 45, 70, 2, 1, 200, 100, True, 33, 25.0, 31),       # two chunks
]


def _bwd_inputs(case, dev, fused: bool, dtype=torch.float32):
    """q, k, v, dO (in ``dtype``) and the options of a ``_BWD_CASES``-style
    case; with ``fused``, q, k and v are strided views of one ``[B, S, (H +
    2 KH) D]`` projection (Sq = Sk, D = Dv)."""
    B, Sq, Sk, H, KH, D, Dv, causal, window, cap, q_offset = case
    g = torch.Generator().manual_seed(0)
    if fused:
        qkv = torch.randn(B, Sq, (H + 2 * KH) * D, generator=g).to(dev,
                                                                    dtype)
        q, k, v = qkv.split([H * D, KH * D, KH * D], dim=-1)
        q, k, v = (t.unflatten(-1, (-1, D)) for t in (q, k, v))
    else:
        q, k, v = [torch.randn(s, generator=g).to(dev, dtype) for s in
                   ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, Dv))]
    do = torch.randn((B, Sq, H, Dv), generator=g).to(dev, dtype)
    opts = dict(causal=causal, window=window, cap=cap, scale=D ** -0.5,
                q_offset=q_offset)
    return q, k, v, do, opts


@pytest.mark.parametrize("case", _BWD_CASES)
def test_flash_attention_lse_and_backward_match_plain_versions(dev, case):
    """The float32 forward's logsumexp (+inf on the same rows) within 2e-5
    and its output within 2e-5 (3xTF32), and ``flash_attention_bwd_f32``'s
    dq, dk, dv within 1e-4 of the plain version's largest magnitude."""
    from repro_torch.kernels.flash_attention import kernel, ref

    q, k, v, do, opts = _bwd_inputs(case, dev, fused=False)
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    r_out, r_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    fin = torch.isfinite(r_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], r_lse[fin], rtol=0, atol=2e-5)
    torch.testing.assert_close(out, r_out, rtol=0, atol=2e-5)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    want = ref.flash_attention_bwd_ref(q, k, v, r_out, r_lse, do, **opts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("D", [64, 18])
def test_flash_attention_backward_on_fused_projection_views(dev, D):
    """q, k, v as strided views of one fused projection (16-byte copies
    at D 64, 4-byte ones at D 18): dq, dk, dv within 1e-4 of the plain
    version's largest magnitude."""
    from repro_torch.kernels.flash_attention import kernel, ref

    case = (2, 77, 77, 8, 2, D, D, True, 40, 30.0, 0)
    q, k, v, do, opts = _bwd_inputs(case, dev, fused=True)
    assert not q.is_contiguous() and q.stride(1) == 12 * D
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("case", [
    (2, 512, 512, 32, 8, 128, 128, True, None, None, 0),
    (1, 300, 260, 8, 2, 20, 12, True, 70, 20.0, 13),
    (1, 96, 96, 4, 2, 256, 256, False, None, 50.0, 0),
])
def test_flash_attention_backward_is_deterministic(dev, case):
    """Two calls on the same inputs give bit-equal dq, dk, dv: the GQA
    group's heads are summed inside one block, in a fixed order, with no
    atomics."""
    from repro_torch.kernels.flash_attention import kernel

    q, k, v, do, opts = _bwd_inputs(case, dev, fused=False)
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    first = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    second = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_combine_weight_grad_matches_plain_version(dev):
    """At the training shape's routing (T 8192, k 2, E 16, C 1280, a
    fifth of the slots dropped), float32 and bf16: within 1e-5 of the
    largest magnitude (float32 sums in another order)."""
    from repro_torch.kernels.moe_dispatch import kernel, ref

    g = torch.Generator().manual_seed(1)
    T, k, d, E, C = 8192, 2, 4096, 16, 1280
    idx = torch.randint(0, E, (T, k), generator=g).to(dev)
    slot = torch.randint(0, C + C // 4, (T, k), generator=g).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(E, C, d, generator=g).to(dev, dtype)
        dy = torch.randn(T, d, generator=g).to(dev, dtype)
        got = kernel.moe_combine_weight_grad(dy, buf, idx, slot)
        want = ref.combine_weight_grad_ref(dy, buf, idx, slot)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert (got[slot >= C] == 0).all()


def test_moe_slot_functions_on_card_match_cpu(dev):
    """``DispatchSlots``/``CombineSlots`` over the kernels: the forward
    and dx, dbuf, dtopk_w equal to the CPU's plain versions."""
    from repro_torch.kernels.moe_dispatch import ops

    rng = np.random.default_rng(2)
    T, k, E, C, d = 300, 2, 8, 64, 96
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(T)]))
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    w = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    out = {}
    for where in (dev, torch.device("cpu")):
        xi, wi = (x.to(where).requires_grad_(True),
                  w.to(where).requires_grad_(True))
        ii = idx.to(where)
        slot = ops.expert_slots(ii, E)
        buf = ops.DispatchSlots.apply(xi, ii, slot, E, C)
        y = ops.CombineSlots.apply(buf * 2.0, ii, slot, wi)
        (y * gy.to(where)).sum().backward()
        out[where.type] = [t.detach().cpu() for t in (y, xi.grad, wi.grad)]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-lite-16b"])
def test_train_gradients_on_card_match_cpu(dev, arch):
    """The training loss's backward on the card (flash attention's
    backward kernel, the MoE's dispatch/combine backward) sets every
    parameter's ``.grad``, equal to the CPU's within rtol 1e-4 and 1e-5 of
    the leaf's largest magnitude (the CPU parity tolerance)."""
    from repro_torch import device as D
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import TrainPolicy, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    params_cpu = init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    params = _tree_to(params_cpu, dev)
    for p in tree_leaves(params_cpu) + tree_leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    step = make_train_step(cfg, adamw(), TrainPolicy())
    D.reset_launch_counts()
    metrics = {}
    for where, p in (("cuda", params), ("cpu", params_cpu)):
        batch = {"tokens": torch.from_numpy(toks).to(where),
                 "labels": torch.from_numpy(labels).to(where)}
        opt = adamw()
        _, _, metrics[where] = step(p, opt.init(p), batch)
    counts = D.launch_counts()
    for name in ("flash_attention_f32", "flash_attention_bwd_f32",
                 "moe_dispatch", "moe_combine", "moe_combine_weight_grad"):
        assert counts[name] > 0, (name, counts)
    torch.testing.assert_close(metrics["cuda"]["loss"].cpu(),
                               metrics["cpu"]["loss"], rtol=1e-5, atol=0)
    for (path, a), (_, b) in zip(tree_paths(params),
                                 tree_paths(params_cpu)):
        assert a.grad is not None, path
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-4,
                                   atol=1e-5 * scale, msg=str(path))


#: the bf16 kernels' cases (D and Dv multiples of 16): D 16 to 256 and
#: MLA's 192/128, causal, window, cap, q_offset, GQA from G 1 to 8, Sq and
#: Sk on either side of the 64- and 128-row tiles; and (fused) strided
#: views of one fused projection
_BF16_BWD_CASES = [
    ((2, 64, 64, 4, 2, 64, 64, True, None, None, 0), False),
    ((2, 100, 70, 8, 2, 64, 64, True, None, None, 30), False),
    ((1, 77, 130, 4, 4, 192, 128, True, None, None, 53), False),   # MLA
    ((2, 96, 48, 8, 2, 64, 64, True, 9, 30.0, 20), False),  # rows see no key
    ((2, 80, 90, 4, 1, 128, 128, False, 7, None, 3), False),
    ((1, 64, 40, 4, 2, 256, 256, False, None, 50.0, 0), False),
    ((2, 256, 256, 32, 8, 128, 128, True, None, None, 0), False),  # Phi's
    ((1, 133, 131, 6, 2, 128, 128, True, 50, 15.0, 5), False),
    ((1, 45, 70, 2, 1, 192, 128, True, 33, 25.0, 31), False),
    ((2, 50, 29, 4, 2, 64, 64, True, 6, None, 27), False),  # rows see no key
    ((2, 77, 77, 8, 2, 64, 64, True, 40, 30.0, 0), True),
    ((1, 130, 130, 4, 2, 128, 128, True, None, None, 0), True),
    # the wgmma kernels' tile edges: 64-row query and key tiles, 128-key
    # dK/dV blocks, 32-query tiles at MLA's widths, dk/dv column chunks
    ((1, 63, 65, 4, 2, 128, 128, True, None, None, 2), False),
    ((1, 127, 129, 4, 1, 64, 64, False, None, None, 0), False),
    ((2, 129, 127, 8, 8, 128, 128, True, None, 20.0, 0), False),  # G = 1
    ((1, 65, 63, 16, 2, 128, 128, True, None, None, 0), False),   # G = 8
    ((1, 150, 200, 4, 2, 128, 128, True, None, None, 37), False),  # diagonal
    ((2, 65, 63, 4, 2, 16, 16, True, None, None, 0), False),      # D 16
    ((1, 129, 127, 4, 2, 256, 256, True, 40, None, 0), False),    # D 256
    ((1, 129, 65, 4, 2, 128, 128, True, 16, None, 20), False),  # no key
    ((1, 65, 129, 4, 4, 192, 128, True, None, None, 64), False),   # MLA
    ((2, 63, 63, 16, 16, 192, 128, False, 20, 30.0, 0), False),
    ((1, 65, 65, 4, 2, 64, 192, True, None, None, 0), False),     # Dv > D
    ((1, 100, 100, 4, 2, 256, 64, False, None, None, 0), False),
]


@pytest.mark.parametrize("case,fused", _BF16_BWD_CASES)
def test_bf16_flash_attention_lse_and_backward_match_plain_versions(
        dev, case, fused):
    """The bf16 forward writing its logsumexp (``flash_attention_lse``):
    its output bit-equal to the serving instantiation's, the logsumexp +inf
    on the plain version's rows and elsewhere within 1e-3 of it; the bf16
    backward (``flash_attention_bwd_bf16``): dq, dk, dv in bf16 within
    2^-6 of the plain version's largest magnitude on the same inputs (P
    and dS are rounded to bf16 as operands, the gradients stored in bf16;
    the plain version keeps float32)."""
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention import kernel, ref

    q, k, v, do, opts = _bwd_inputs(case, dev, fused, torch.bfloat16)
    assert fused == (not q.is_contiguous())
    D.reset_launch_counts()
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    assert torch.equal(out, kernel.flash_attention_fwd(q, k, v, **opts))
    r_out, r_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    fin = torch.isfinite(r_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], r_lse[fin], rtol=0, atol=1e-3)
    got = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape
        torch.testing.assert_close(a.float(), b, rtol=0,
                                   atol=2 ** -6 * float(b.abs().max()))
    counts = D.launch_counts()
    assert counts["flash_attention_lse"] == 1
    assert counts["flash_attention_bwd_bf16"] == 1


@pytest.mark.parametrize("case", [
    (2, 512, 512, 32, 8, 128, 128, True, None, None, 0),
    (1, 300, 260, 8, 2, 64, 64, True, 70, 20.0, 13),
    (1, 96, 96, 4, 4, 192, 128, False, None, 50.0, 0),
    (1, 129, 127, 8, 1, 256, 256, True, 40, None, 0),
    (2, 65, 63, 4, 4, 16, 16, True, None, None, 10),
    (1, 127, 129, 16, 2, 128, 128, True, 30, 20.0, 37),
])
def test_bf16_flash_attention_backward_is_deterministic(dev, case):
    """Two calls of the bf16 backward on the same inputs give bit-equal dq,
    dk, dv: no atomics, the GQA group summed in one block in a fixed
    order."""
    from repro_torch.kernels.flash_attention import kernel

    q, k, v, do, opts = _bwd_inputs(case, dev, False, torch.bfloat16)
    out, lse = kernel.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    first = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    second = kernel.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_attention_with_a_gradient_runs_the_kernels(dev):
    """A bf16 call that needs a gradient goes through ``FlashAttention``:
    the forward with its logsumexp and the bf16 backward, gradients in
    bf16, and a ``dout`` view that breaks the 16-byte rule copied first;
    under ``torch.no_grad()`` (serving) the serving forward runs."""
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.randn(1, 32, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, 32, 2, 64, device=dev, dtype=torch.bfloat16)
    D.reset_launch_counts()
    q.requires_grad_(True)
    out = flash_attention(q, k, k)
    g = torch.randn(1, 32, 4, 72, device=dev, dtype=torch.bfloat16)
    out.backward(g[..., 4:68])
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == (1, 32, 4, 64)
    counts = D.launch_counts()
    assert (counts["flash_attention_lse"], counts["flash_attention_bwd_bf16"],
            counts["flash_attention"]) == (1, 1, 1)


def test_moe_slot_functions_in_bf16_on_card_match_cpu(dev):
    """``DispatchSlots``/``CombineSlots`` over the kernels on bf16
    activations with float32 routing weights: the forward and dx within a
    bf16 rounding of the CPU's plain versions (each sums the same terms),
    dtopk_w (float32, from bf16 dy and buffer) within 1e-5 of its largest
    magnitude."""
    from repro_torch.kernels.moe_dispatch import ops

    rng = np.random.default_rng(4)
    T, k, E, C, d = 300, 2, 8, 64, 96
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(T)]))
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    w = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    out = {}
    for where in (dev, torch.device("cpu")):
        xi = x.to(where, torch.bfloat16).requires_grad_(True)
        wi = w.to(where).requires_grad_(True)
        ii = idx.to(where)
        slot = ops.expert_slots(ii, E)
        buf = ops.DispatchSlots.apply(xi, ii, slot, E, C)
        y = ops.CombineSlots.apply(buf * 2.0, ii, slot, wi)
        (y * gy.to(where, torch.bfloat16)).sum().backward()
        out[where.type] = [t.detach().cpu() for t in (y, xi.grad, wi.grad)]
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -8,
                                   atol=1e-6 * float(b.float().abs().max()))
    a, b = out["cuda"][2], out["cpu"][2]
    assert a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def _rel_l2(got, want):
    """Per-leaf and whole-tree ``‖got − want‖ / ‖want‖`` (float64)."""
    per, num, den = [], 0.0, 0.0
    for a, b in zip(got, want):
        a, b = a.double().cpu(), b.double().cpu()
        d2, w2 = float(((a - b) ** 2).sum()), float((b * b).sum())
        per.append((d2 / w2) ** 0.5 if w2 else d2 ** 0.5)
        num, den = num + d2, den + w2
    return per, (num / den) ** 0.5


@pytest.mark.parametrize("arch,hybrid", [("phi3.5-moe-42b-a6.6b", False),
                                         ("deepseek-v2-lite-16b", False),
                                         ("jamba-1.5-large-398b", False),
                                         ("jamba-1.5-large-398b", True)])
def test_bf16_train_gradients_on_card_match_cpu(dev, arch, hybrid):
    """The bf16 training loss's backward on the card (the bf16 attention
    forward with its logsumexp and backward kernels, the MoE kernels on
    bf16 activations) sets every parameter's ``.grad``.  bf16 gradients
    differ from float32 ones by 15-50% of a leaf's largest magnitude at
    smoke size wherever they run, so they are held as relative L2 errors
    against the CPU's float32 gradients at the same bf16-valued weights:
    over the whole tree at most 1.25 times the CPU bf16 run's error plus
    0.01, each leaf at most 0.3.  ``hybrid``: the >100 B hybrid's policy
    (``default_policy``: Adafactor, gradients summed in bf16), over 2
    microbatches, so the bf16 accumulation runs (the float32 run sums in
    float32).  DeepSeek-V2-Lite's smoke config keeps
    its MLA at q/k 32 (16 + 16 rope) and v 16: the bf16 kernels take head
    dims that are multiples of 16 (the full config's 192/128 are); its
    own 24 is in ``test_bf16_mla_at_its_smoke_head_dim_serves_and_trains``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    if cfg.kv_lora_rank:
        cfg = dataclasses.replace(cfg, head_dim=32, qk_nope_dim=16,
                                  qk_rope_dim=16)
    _check_bf16_train_gradients(dev, cfg, hybrid)


def _check_bf16_train_gradients(dev, cfg, hybrid: bool) -> None:
    """``test_bf16_train_gradients_on_card_match_cpu``'s check for ``cfg``."""
    from repro_torch import device as D
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.trainer import TrainPolicy, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_map, tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    p16 = init_model(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     device="cpu")
    runs = {"cuda": _tree_to(p16, dev), "cpu": p16,
            "f32": tree_map(lambda t: t.float().clone(), p16)}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    D.reset_launch_counts()
    for name, p in runs.items():
        for t in tree_leaves(p):
            t.requires_grad_(True)
        where = "cuda" if name == "cuda" else "cpu"
        batch = {"tokens": torch.from_numpy(toks).to(where),
                 "labels": torch.from_numpy(labels).to(where)}
        opt = adafactor() if hybrid else adamw()
        policy = TrainPolicy(
            optimizer=opt.name, microbatches=2 if hybrid else 1,
            grad_accum_dtype=(torch.bfloat16 if hybrid and name != "f32"
                              else torch.float32))
        make_train_step(cfg, opt, policy)(p, opt.init(p), batch)
    counts = D.launch_counts()
    kernels = ["flash_attention_lse", "flash_attention_bwd_bf16"]
    if cfg.uses_moe:
        kernels += ["moe_dispatch", "moe_combine", "moe_combine_weight_grad"]
    for name in kernels:
        assert counts[name] > 0, (name, counts)
    grads = {}
    for name, p in runs.items():
        paths = list(tree_paths(p))
        for path, t in paths:
            assert t.grad is not None, (name, path)
        grads[name] = [t.grad for _, t in paths]
    card, card_tree = _rel_l2(grads["cuda"], grads["f32"])
    cpu, cpu_tree = _rel_l2(grads["cpu"], grads["f32"])
    assert card_tree <= 1.25 * cpu_tree + 0.01, (card_tree, cpu_tree)
    assert max(card) <= 0.3, max(zip(card, [p for p, _ in paths]))


def test_bf16_attention_pads_head_dims_the_kernel_does_not_take(dev):
    """bf16 attention at DeepSeek-V2-Lite's smoke widths (q/k 24, v 16),
    which ``select_kernel`` refuses: ``ops.flash_attention`` pads q, k and
    v with zero columns to 32 and 16, keeps the scale of D 24, and slices
    the output back, so the kernels run.  Values and gradients against the
    plain version of the unpadded inputs in float32, within the bf16
    kernels' tolerances (2^-6 relative + 2e-3; gradients 2^-6 of their
    largest magnitude); the output comes back contiguous."""
    from repro_torch import device as D
    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.ops import flash_attention

    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(*s, generator=g).to(dev, torch.bfloat16)
                   for s in ((2, 40, 4, 24), (2, 40, 2, 24), (2, 40, 2, 16),
                             (2, 40, 4, 16)))
    with pytest.raises(ValueError, match="multiples of 16"):
        kernel.select_kernel(q, k, v)
    opts = dict(causal=True, window=None, cap=None, scale=24 ** -0.5,
                q_offset=0)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = ref.flash_attention_ref(*leaves, **opts)
    (want * do.float()).sum().backward()
    D.reset_launch_counts()
    with torch.no_grad():
        served = flash_attention(q, k, v)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg)
    out.backward(do)
    counts = D.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_lse"],
            counts["flash_attention_bwd_bf16"]) == (1, 1, 1)
    for got in (served, out):
        assert got.shape == (2, 40, 4, 16) and got.is_contiguous()
        torch.testing.assert_close(got.float(), want.detach(),
                                   rtol=2.0 ** -6, atol=2e-3)
    for a, t in zip((qg, kg, vg), leaves):
        assert a.grad.dtype == torch.bfloat16 and a.grad.shape == a.shape
        torch.testing.assert_close(a.grad.float(), t.grad, rtol=0,
                                   atol=2 ** -6 * float(t.grad.abs().max()))


def test_bf16_mla_at_its_smoke_head_dim_serves_and_trains(dev):
    """DeepSeek-V2-Lite's registered smoke config at its own MLA widths
    (q/k 24 = 16 + 8 rope, v 16) in bf16 on the card, beside the widened
    case above.  Serving: the prefill logits (the bf16 serving kernel)
    held to the float32 CPU logits at the same bf16-valued weights by the
    bf16 training rule (relative L2 at most 1.25 times the CPU bf16
    run's plus 0.01), and ``generate`` returns finite tokens.  Training:
    ``test_bf16_train_gradients_on_card_match_cpu``'s check."""
    from repro_torch import device as D
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.serving.engine import generate, make_prefill_step
    from repro_torch.train.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    assert cfg.head_dim == 24 and cfg.v_head_dim == 16
    p16 = init_model(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     device="cpu")
    runs = {"cuda": _tree_to(p16, dev), "cpu": p16,
            "f32": tree_map(lambda t: t.float().clone(), p16)}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    logits = {}
    D.reset_launch_counts()
    with torch.no_grad():
        for name, p in runs.items():
            where = "cuda" if name == "cuda" else "cpu"
            batch = {"tokens": torch.from_numpy(toks).to(where)}
            logits[name] = make_prefill_step(cfg)(p, batch)[0].float().cpu()
        out = generate(runs["cuda"], cfg, toks[:, :8], 6)
    assert D.launch_counts()["flash_attention"] > 0
    assert torch.isfinite(logits["cuda"]).all()
    (card,), card_tree = _rel_l2([logits["cuda"]], [logits["f32"]])
    _, cpu_tree = _rel_l2([logits["cpu"]], [logits["f32"]])
    assert card_tree <= 1.25 * cpu_tree + 0.01, (card_tree, cpu_tree)
    assert np.asarray(out).shape[0] == 2
    assert np.all((np.asarray(out) >= 0) & (np.asarray(out) < cfg.vocab_size))
    _check_bf16_train_gradients(dev, cfg, False)


def test_launch_train_on_card(dev, tmp_path):
    """``launch.train --device cuda --smoke``: the pipeline's join and
    sort and the train step on the card, then a resume from step 2 with
    the uninterrupted run's losses (within 1e-6: the card's atomics sum
    the embedding's gradient in any order)."""
    from repro_torch.launch import train

    args = ["--device", "cuda", "--smoke", "--arch", "phi3.5-moe-42b-a6.6b",
            "--seq-len", "32", "--batch", "2"]
    whole = train.main(args + ["--steps", "4"])
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"]
    train.main(args + ckpt + ["--steps", "2"])
    resumed = train.main(args + ckpt + ["--steps", "4"])
    assert resumed["start"] == 2
    for s in (2, 3):
        assert resumed["losses"][s] == pytest.approx(whole["losses"][s],
                                                     rel=1e-6)


def test_launch_train_in_bf16_on_card(dev):
    """``launch.train --device cuda --smoke --dtype bfloat16``: the bf16
    step on the card (the attention forward with its logsumexp and the
    bf16 backward kernel) with finite losses."""
    from repro_torch import device as D
    from repro_torch.launch import train

    D.reset_launch_counts()
    out = train.main(["--device", "cuda", "--smoke", "--arch",
                      "phi3.5-moe-42b-a6.6b", "--seq-len", "32", "--batch",
                      "2", "--steps", "3", "--dtype", "bfloat16"])
    assert all(np.isfinite(out["losses"][s]) for s in range(3))
    counts = D.launch_counts()
    assert counts["flash_attention_lse"] > 0
    assert counts["flash_attention_bwd_bf16"] > 0


def test_kernel_wrappers_on_a_split_mesh_on_card(dev, tmp_path):
    """The hand kernels under ``local_map`` on a (2, 2) mesh of 4 NCCL
    ranks, a card each: query heads and experts split over ``"model"``, so
    each rank's kernels see its K/V head slice (or gather, where 6 heads
    over 2 ranks straddle GQA groups) and the expert ids of the other
    ``"model"`` rank offset out of range, which the dispatch and combine
    kernels drop.  Values and the gradients of every input (dK/dV and dx
    summed over ``"model"``) against the same wrappers on plain tensors,
    which launch the kernels unsplit; the split calls launch every kernel
    of the path.  NCCL takes one rank a card, and gloo's functional
    all-gather faults on CUDA tensors, so fewer than 4 cards skip."""
    from torch_dist_common import kernel_wrappers_worker, run_ranks

    from repro_torch.device import kernel_library

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: a (2, 2) NCCL mesh, one rank a card")
    kernel_library("moe_dispatch")   # built once, before the ranks start
    out = run_ranks(kernel_wrappers_worker, 4, str(tmp_path / "out.json"),
                    "cuda", 2, timeout=300, backend="nccl")
    for heads in ("4_2", "4_1", "6_3", "4_4"):
        r = out[f"attn_{heads}"]
        assert r["err"] < 1e-5 and r["grad_err"] < 1e-5, (heads, r)
        assert r["placements"] == ["S(0)", "S(2)"], (heads, r)
    r = out["moe_layer"]
    assert r["err"] < 1e-5 and r["grad_err"] < 1e-5, r
    r = out["single_ops"]
    assert r["expert_slots"]
    assert r["dispatch"] == 0.0 and r["combine_slots"] == 0.0, r
    for name in ("flash_attention_f32", "flash_attention_bwd_f32",
                 "moe_dispatch", "moe_combine", "moe_combine_weight_grad"):
        assert out["launched"].get(name, 0) > 0, out["launched"]
