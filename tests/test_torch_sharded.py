"""Parity of the port's partition-parallel (sharded) fused fragment with
the reference's, on the CPU.

The reference runs ``repro.core.fused.run_fused(..., shards=N)`` under
``shard_map`` on the eight forced host-platform devices of
``tests/conftest.py`` (the ``eight_device_mesh`` fixture); the port runs
the same fragment over eight logical lanes with ``device="cpu"``.  The
same numpy tables, made from a seed, go through both.  Every comparison is
exact: the scalar, the partitioned layouts, and the counters
(``h2d_bytes``, ``h2d_bytes_logical``, ``host_syncs``, ``devices``,
``peak_working_set_bytes``, ``compiled``), with the device codecs on and
off.  The cases are those of ``tests/test_sharded_parity.py`` plus layout
parity, integer dtypes whose sums pass 2^31 and 2^32, and the broker's
gang leases and the sharded cost term driven against the port's classes.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import fused as jfused  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import fused as tfused  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from test_sharded_parity import _host_agg as host_agg  # noqa: E402

CPU = {"device": "cpu"}


@pytest.fixture(params=["on", "off"])
def compress(request, monkeypatch):
    """The device codecs on (packed payloads) and off (raw columns)."""
    monkeypatch.setenv("REPRO_DEVICE_COMPRESS",
                       "1" if request.param == "on" else "0")
    return request.param


def _both(cols):
    """One reference and one port Relation over the same numpy columns."""
    return (R.Relation({k: np.asarray(v) for k, v in cols.items()}),
            T.Relation({k: np.asarray(v) for k, v in cols.items()}))


def _spec(M, col_name, fn, filt=None, sort_keys=()):
    return M.FusedSpec(join_key="uid", filter_fn=filt, sort_keys=sort_keys,
                       agg=(col_name, fn))


def _host_agg(build, probe, key, col_name, fn, filt=None):
    """``tests/test_sharded_parity.py``'s numpy answer over the dict
    tables (``filt`` an expression built with ``R.col``)."""
    return host_agg(R.Relation(build), R.Relation(probe), key, col_name, fn,
                    filt)


def _counters(m):
    return (m.host_syncs, m.devices, m.h2d_bytes, m.h2d_bytes_logical,
            m.peak_working_set_bytes, m.rows_out, m.path, m.op)


def _run_both(spec_of, build, probe, shards=8):
    """Run the fragment through both engines; returns ``((ref result,
    ref metrics), (port result, port metrics))`` for fresh Relations."""
    bj, bt = _both(build)
    pj, pt = _both(probe)
    ref = jfused.run_fused(spec_of(R), bj, pj, shards=shards)
    port = tfused.run_fused(spec_of(T), bt, pt, shards=shards, **CPU)
    return ref, port


def _assert_same(ref, port, ctx=""):
    (rj, mj), (rt, mt) = ref, port
    assert isinstance(rt, float), ctx
    assert rt == rj, ctx  # bit for bit, not approx
    assert _counters(mt) == _counters(mj), ctx


AGG_CASES = [
    ("w", "sum", False),
    ("w", "sum", True),
    ("w", "count", False),
    ("w", "count", True),
    ("w", "min", False),
    ("w", "max", False),
    ("b_region", "max", False),
    ("b_region", "min", True),
]


@pytest.mark.parametrize("col_name,fn,filtered", AGG_CASES)
def test_sharded_matches_reference_and_host(eight_device_mesh, compress,
                                            col_name, fn, filtered):
    rng = np.random.default_rng(7)
    n_b, n_p = 20_000, 30_000
    build = {"uid": rng.integers(-5_000, 5_000, n_b).astype(np.int64),
             "region": rng.integers(0, 10, n_b).astype(np.int64)}
    probe = {"uid": rng.integers(-5_000, 5_000, n_p).astype(np.int64),
             "w": rng.integers(-100, 100, n_p).astype(np.int64)}

    def spec_of(M):
        return _spec(M, col_name, fn, (M.col("w") > 0) if filtered else None)

    ref, port = _run_both(spec_of, build, probe)
    _assert_same(ref, port, f"{col_name}/{fn}/{filtered}")
    assert port[1].devices == 8 and port[1].host_syncs == 1
    host = _host_agg(build, probe, "uid", col_name, fn,
                     (R.col("w") > 0) if filtered else None)
    assert port[0] == host
    # the port's single-device program gives the same float
    single, m1 = tfused.run_fused(spec_of(T), T.Relation(build),
                                  T.Relation(probe), **CPU)
    assert m1.devices == 1 and single == port[0]


def test_sharded_skewed_zipf_keys(eight_device_mesh):
    rng = np.random.default_rng(11)
    n = 6_000
    build = {"uid": np.minimum(rng.zipf(1.3, n), 1 << 40).astype(np.int64),
             "region": rng.integers(0, 4, n).astype(np.int64)}
    probe = {"uid": np.minimum(rng.zipf(1.3, n), 1 << 40).astype(np.int64),
             "w": rng.integers(-50, 50, n).astype(np.int64)}
    ref, port = _run_both(
        lambda M: _spec(M, "w", "sum", M.col("w") > 0), build, probe)
    _assert_same(ref, port)
    assert port[0] == _host_agg(build, probe, "uid", "w", "sum",
                                R.col("w") > 0)
    # the skew really concentrates the keys: one partition holds most rows
    counts = tpart.partition_counts(T.Relation(build), "uid", 8)
    assert tpart.partition_skew(counts) > 2.0


@pytest.mark.parametrize("fn", ["sum", "count", "min", "max"])
def test_sharded_empty_partitions(eight_device_mesh, fn):
    # one distinct key puts EVERY row in one partition: the other seven
    # run over all-sentinel padding and must contribute identities
    rng = np.random.default_rng(3)
    n = 2_000
    build = {"uid": np.full(n, 42, np.int64),
             "region": rng.integers(0, 4, n).astype(np.int64)}
    probe = {"uid": np.full(n // 4, 42, np.int64),
             "w": rng.integers(1, 9, n // 4).astype(np.int64)}
    ref, port = _run_both(lambda M: _spec(M, "w", fn), build, probe)
    _assert_same(ref, port, fn)
    assert np.count_nonzero(
        tpart.partition_counts(T.Relation(build), "uid", 8)) == 1
    assert port[0] == _host_agg(build, probe, "uid", "w", fn)


def test_sharded_rows_not_divisible_by_partitions(eight_device_mesh):
    rng = np.random.default_rng(5)
    n_b, n_p = 10_003, 7_919  # both prime: never divide 8
    build = {"uid": rng.integers(0, 2_000, n_b).astype(np.int64),
             "region": rng.integers(0, 3, n_b).astype(np.int64)}
    probe = {"uid": rng.integers(0, 2_000, n_p).astype(np.int64),
             "w": rng.integers(-10, 10, n_p).astype(np.int64)}
    ref, port = _run_both(lambda M: _spec(M, "w", "sum"), build, probe)
    _assert_same(ref, port)
    assert port[0] == _host_agg(build, probe, "uid", "w", "sum")


def test_sharded_empty_min_raises_like_reference(eight_device_mesh):
    # disjoint key domains: zero joined rows; min has no identity
    build = {"uid": np.arange(0, 100, dtype=np.int64),
             "region": np.zeros(100, np.int64)}
    probe = {"uid": np.arange(1_000, 1_100, dtype=np.int64),
             "w": np.ones(100, np.int64)}
    bj, bt = _both(build)
    pj, pt = _both(probe)
    with pytest.raises(ValueError, match="no identity"):
        jfused.run_fused(_spec(R, "w", "min"), bj, pj, shards=8)
    with pytest.raises(ValueError, match="no identity"):
        tfused.run_fused(_spec(T, "w", "min"), bt, pt, shards=8, **CPU)


def test_sharded_warm_second_query(eight_device_mesh, compress):
    rng = np.random.default_rng(9)
    n = 30_000
    build = {"uid": rng.integers(0, 10_000, n).astype(np.int64),
             "region": rng.integers(0, 4, n).astype(np.int64)}
    probe = {"uid": rng.integers(0, 10_000, n).astype(np.int64),
             "w": rng.integers(-5, 5, n).astype(np.int64)}
    bj, bt = _both(build)
    pj, pt = _both(probe)
    jfused.pipeline_cache_clear()
    tfused.pipeline_cache_clear()
    runs = {}
    for name, M, F, kw in (("ref", R, jfused, {}), ("port", T, tfused, CPU)):
        b, p = (bj, pj) if M is R else (bt, pt)
        runs[name] = [F.run_fused(_spec(M, "w", "sum"), b, p, shards=8, **kw)
                      for _ in range(2)]
    for (rj, mj), (rt, mt) in zip(runs["ref"], runs["port"]):
        assert rt == rj
        assert _counters(mt) == _counters(mj)
        assert mt.compiled == mj.compiled
    (_, cold), (_, warm) = runs["port"]
    assert cold.h2d_bytes > 0 and cold.compiled
    assert warm.h2d_bytes == 0 and warm.host_syncs == 1
    assert not warm.compiled
    assert tfused.pipeline_cache_info() == jfused.pipeline_cache_info()


def test_sharded_capacity_overflow_retries_once(eight_device_mesh):
    # one hot key with 500 build-side duplicates and the probe aimed at
    # it: the sampled duplication factor underestimates the critical
    # partition's output, the optimistic capacity overflows, the run loop
    # retries at the exact bucket, and the verified bucket is remembered
    rng = np.random.default_rng(13)
    build_keys = np.concatenate([np.arange(1_000, 2_500, dtype=np.int64),
                                 np.full(500, 7, np.int64)])
    build = {"uid": build_keys,
             "region": rng.integers(0, 3, len(build_keys)).astype(np.int64)}
    probe = {"uid": np.full(200, 7, np.int64), "w": np.ones(200, np.int64)}
    bj, bt = _both(build)
    pj, pt = _both(probe)
    syncs = {}
    for M, F, kw, b, p in ((R, jfused, {}, bj, pj),
                           (T, tfused, CPU, bt, pt)):
        first = F.run_fused(_spec(M, "w", "count"), b, p, shards=8, **kw)
        again = F.run_fused(_spec(M, "w", "count"), b, p, shards=8, **kw)
        assert first[0] == again[0] == 200.0 * 500.0
        syncs[M.__name__] = (first[1].host_syncs, again[1].host_syncs,
                             first[1].peak_working_set_bytes,
                             again[1].peak_working_set_bytes)
    assert syncs["repro_torch.core"] == syncs["repro.core"]
    assert syncs["repro_torch.core"][:2] == (2, 1)


@pytest.mark.parametrize("dtype,fn,lo,hi", [
    ("int32", "sum", 1 << 20, (1 << 31) - 1),   # the sum passes 2^31
    ("uint32", "sum", 1 << 30, (1 << 32) - 1),  # the sum passes 2^32
    ("uint32", "max", 0, (1 << 32) - 1),
    ("uint64", "sum", 1 << 51, 1 << 52),        # the sum passes 2^63
    ("int16", "sum", -(1 << 15), (1 << 15) - 1),
])
def test_sharded_integer_dtypes(eight_device_mesh, compress, dtype, fn, lo,
                                hi):
    rng = np.random.default_rng(17)
    n_b, n_p = 3_000, 5_000
    build = {"uid": rng.permutation(n_b).astype(np.int64),
             "v": rng.integers(lo, hi, n_b, dtype=np.uint64
                               if dtype == "uint64" else np.int64
                               ).astype(dtype)}
    probe = {"uid": rng.integers(0, n_b + 100, n_p).astype(np.int64),
             "w": rng.integers(-9, 9, n_p).astype(np.int64)}
    ref, port = _run_both(lambda M: _spec(M, "b_v", fn), build, probe)
    _assert_same(ref, port, dtype)
    assert port[0] == _host_agg(build, probe, "uid", "b_v", fn)
    bits = {"int32": 31, "uint32": 32, "uint64": 63}
    if fn == "sum" and dtype in bits:
        assert port[0] > 1 << bits[dtype]


def test_sharded_supported_eligibility_matches_reference():
    rng = np.random.default_rng(1)
    n = 100
    tables = {
        "ints": {"uid": rng.integers(0, 10, n).astype(np.int64),
                 "w": rng.integers(0, 10, n).astype(np.int64)},
        "floats": {"uid": rng.integers(0, 10, n).astype(np.int64),
                   "w": rng.random(n)},
        "fkey": {"uid": rng.random(n),
                 "w": rng.integers(0, 10, n).astype(np.int64)},
        "u32": {"uid": rng.integers(0, 10, n).astype(np.uint32),
                "w": rng.integers(0, 10, n).astype(np.uint32)},
    }
    aggs = [("w", "sum"), ("w", "min"), ("w", "max"), ("w", "count"),
            ("b_w", "sum"), ("missing", "sum"), None]
    table = {}
    for b in tables:
        for p in tables:
            for agg in aggs:
                bj, bt = _both(tables[b])
                pj, pt = _both(tables[p])
                got = [F.sharded_supported(
                    M.FusedSpec("uid", None, ("w",) if agg is None else (),
                                agg), bx, px)
                    for M, F, bx, px in ((R, jfused, bj, pj),
                                         (T, tfused, bt, pt))]
                assert got[0] == got[1], (b, p, agg)
                table[(b, p, agg)] = got[1]
    assert table[("ints", "ints", ("w", "sum"))]
    assert not table[("ints", "floats", ("w", "sum"))]
    assert table[("ints", "floats", ("w", "min"))]
    assert table[("ints", "floats", ("w", "count"))]
    assert not table[("fkey", "ints", ("w", "sum"))]
    assert not table[("ints", "ints", None)]
    assert "sharded_supported" in tfused.__all__


def test_unsupported_fragment_degrades_to_single_device(eight_device_mesh):
    rng = np.random.default_rng(2)
    n = 5_000
    build = {"uid": rng.integers(0, 100, n).astype(np.int64),
             "region": rng.integers(0, 4, n).astype(np.int64)}
    probe = {"uid": rng.integers(0, 100, n).astype(np.int64),
             # a float sum is not bit-for-bit shardable; integer values
             # keep it exact in any order, so both engines agree exactly
             "w": rng.integers(-50, 50, n).astype(np.float64)}
    ref, port = _run_both(lambda M: _spec(M, "w", "sum"), build, probe)
    _assert_same(ref, port)
    assert port[1].devices == 1
    assert port[0] == _host_agg(build, probe, "uid", "w", "sum")


# ---------------------------------------------------------------------------
# The partitioned layout
# ---------------------------------------------------------------------------

def test_partition_layout_matches_reference(eight_device_mesh, compress):
    import jax

    rng = np.random.default_rng(19)
    n = 9_000
    cols = {"uid": rng.integers(-3_000, 3_000, n).astype(np.int64),
            "small": rng.integers(0, 7, n).astype(np.int64),
            "wide": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "f": rng.random(n),
            "u": rng.integers(0, 1 << 32, n, dtype=np.uint64
                              ).astype(np.uint32)}
    rj, rt = _both(cols)
    keys = cols["uid"]
    for parts in (1, 2, 8):
        np.testing.assert_array_equal(tpart.partition_of(keys, parts),
                                      jpart.partition_of(keys, parts))
        np.testing.assert_array_equal(
            tpart.partition_counts(rt, "uid", parts),
            jpart.partition_counts(rj, "uid", parts))
        for sort_within in (True, False):
            assert (tpart.pending_partition_bytes(rt, "uid", parts,
                                                  sort_within, "cpu")
                    == jpart.pending_partition_bytes(rj, "uid", parts,
                                                     sort_within))
            got = tpart.get_partitioned_columns(rt, "uid", parts,
                                                sort_within, "cpu")
            want = jpart.get_partitioned_columns(rj, "uid", parts,
                                                 sort_within)
            (cols_t, cdev_t, counts_t, bucket_t, up_t, log_t, lay_t,
             dicts_t) = got
            (cols_j, cdev_j, counts_j, bucket_j, up_j, log_j, lay_j,
             dicts_j) = want
            assert (bucket_t, up_t, log_t) == (bucket_j, up_j, log_j)
            assert up_t > 0
            assert ({k: dataclasses.astuple(v) for k, v in lay_t.items()}
                    == {k: dataclasses.astuple(v) for k, v in lay_j.items()})
            packed = {k for k, v in lay_t.items() if v.encoding != "raw"}
            assert bool(packed) == (compress == "on"), packed
            np.testing.assert_array_equal(counts_t, counts_j)
            np.testing.assert_array_equal(cdev_t.numpy(),
                                          jax.device_get(cdev_j))
            assert set(cols_t) == set(cols_j)
            for name in cols_j:
                host = jax.device_get(cols_j[name])
                assert cols_t[name].shape == (parts, bucket_t)
                assert cols_t[name].numpy().dtype == host.dtype, name
                np.testing.assert_array_equal(cols_t[name].numpy(), host)
            assert set(dicts_t) == set(dicts_j)
            for name in dicts_j:
                np.testing.assert_array_equal(
                    dicts_t[name].numpy(), jax.device_get(dicts_j[name]))
            # resident now: a second call moves nothing
            assert tpart.pending_partition_bytes(rt, "uid", parts,
                                                 sort_within, "cpu") == 0
            assert tpart.get_partitioned_columns(
                rt, "uid", parts, sort_within, "cpu")[4] == 0


def test_partition_bucket_and_skew_match_reference():
    for n in (0, 1, 4095, 4096, 4097, 5000, 6000, 7169, 10_000, 1 << 20,
              (1 << 20) + 1, 750_000, 3_000_001):
        assert tpart.partition_bucket(n) == jpart.partition_bucket(n), n
    for counts in ([0, 0], [5, 5, 5, 5], [40, 0, 0, 0], [1, 2, 3]):
        c = np.asarray(counts, np.int64)
        assert tpart.partition_skew(c) == jpart.partition_skew(c)
    assert tpart.PART_MIN_BUCKET == jpart.PART_MIN_BUCKET


def test_partition_cache_is_per_device_and_invalidates():
    rng = np.random.default_rng(23)
    rel = T.Relation({"uid": rng.integers(0, 500, 3_000).astype(np.int64),
                      "w": rng.integers(0, 5, 3_000).astype(np.int64)})
    tpart.partition_cache_clear()
    first = tpart.get_partitioned_columns(rel, "uid", 4, True, "cpu")
    assert first[4] > 0
    assert tpart.get_partitioned_columns(rel, "uid", 4, True, "cpu")[4] == 0
    # another device is another entry: pending again, not resident
    assert tpart.pending_partition_bytes(rel, "uid", 4, True, "meta") > 0
    rel.invalidate_device_cache()
    assert tpart.pending_partition_bytes(rel, "uid", 4, True, "cpu") > 0
    again = tpart.get_partitioned_columns(rel, "uid", 4, True, "cpu")
    assert again[4] == first[4]
    info = tpart.partition_cache_info()
    assert info["misses"] >= 2 and info["hits"] >= 1
    assert info["h2d_bytes"] == 2 * first[4]


def test_logical_lanes():
    assert tsharding.available_partitions() == 8
    assert tsharding.check_partitions(8) == 8
    for bad in (0, 9):
        with pytest.raises(ValueError):
            tsharding.check_partitions(bad)


# ---------------------------------------------------------------------------
# Broker lanes and the sharded cost term, against the port's classes
# ---------------------------------------------------------------------------

def test_gang_lease_acquire_release_order():
    broker = T.ResourceBroker(None)
    broker.ensure_lanes(4)
    assert len(broker.lanes) == 4
    broker.ensure_lanes(2)  # never shrinks
    assert len(broker.lanes) == 4
    broker.ensure_lanes(4)  # idempotent
    assert len(broker.lanes) == 4
    # lane 0 IS the single-dispatch device queue
    assert broker.lanes[0] is broker.device

    gang = broker.device_lease(lanes=4)
    assert gang.lanes == 4
    assert len(gang.lane_waits) == 4
    for q in broker.lanes:
        assert q.stats()["depth"] >= 1
    gang.release()
    with pytest.raises(RuntimeError):
        gang.release()
    for q in broker.lanes:
        assert q.stats()["depth"] == 0
    # single-lane requests still return a plain lease
    lease = broker.device_lease()
    assert not hasattr(lease, "lane_waits")
    lease.release()


def test_gang_lease_auto_grows_lanes():
    broker = T.ResourceBroker(None)
    with broker.device_lease(lanes=3) as gang:
        assert gang.lanes == 3
    assert len(broker.lanes) == 3


def test_lane_stats_in_broker_stats_and_since():
    broker = T.ResourceBroker(None)
    broker.ensure_lanes(2)
    base = broker.stats()
    assert len(base.lanes) == 2
    broker.device_lease(lanes=2).release()
    broker.device_lease(lanes=2).release()
    delta = broker.stats().since(base)
    assert len(delta.lanes) == 2
    for lane in delta.lanes:
        assert lane["dispatches"] == 2
        assert "ewma_wait_s" in lane
        assert "peak_depth" in lane
        assert "coalesced" in lane


def test_price_quotes_per_lane_waits():
    broker = T.ResourceBroker(None)
    broker.ensure_lanes(4)
    q1 = broker.price(T.ResourceRequest("device"))
    assert len(q1.lane_waits) == 1  # single-lane request: lane 0 only
    q4 = broker.price(T.ResourceRequest("device", lanes=4))
    assert len(q4.lane_waits) == 4
    assert q4.expected_wait_s == max(q4.lane_waits)
    # lanes beyond the current lane set price as empty queues
    q8 = broker.price(T.ResourceRequest("device", lanes=8))
    assert len(q8.lane_waits) == 8
    assert all(w == 0.0 for w in q8.lane_waits[4:])


def test_cost_model_sharded_term_ordering():
    model = T.CostModel()
    ref = R.CostModel()
    kw = dict(n_build=1_000_000, n_probe=1_000_000, row_bytes_b=16,
              row_bytes_p=16, est_out=1_000_000, work_mem=32 << 20,
              has_agg=True)
    single = model.estimate_fragment(**kw)
    assert math.isinf(single.t_tensor_sharded)  # no fan-out requested
    sharded = model.estimate_fragment(**kw, device_count=8)
    assert sharded.t_tensor_sharded < sharded.t_tensor
    assert (sharded.t_tensor_sharded
            == ref.estimate_fragment(**kw, device_count=8).t_tensor_sharded)
    skewed = model.estimate_fragment(**kw, device_count=8, partition_skew=8.0)
    assert skewed.t_tensor_sharded > sharded.t_tensor_sharded
    # aggregate-free fragments never price a sharded plan
    no_agg = model.estimate_fragment(**{**kw, "has_agg": False},
                                     device_count=8)
    assert math.isinf(no_agg.t_tensor_sharded)


def test_gang_lease_excludes_single_lane_dispatch():
    """A gang holds lane 0, so a single-lane dispatch waits for it: on one
    card gangs and single dispatches never overlap."""
    import threading

    broker = T.ResourceBroker(None)
    gang = broker.device_lease(lanes=8)
    got = threading.Event()

    def single():
        broker.device_lease().release()
        got.set()

    th = threading.Thread(target=single, daemon=True)
    th.start()
    assert not got.wait(0.2)
    gang.release()
    assert got.wait(5)
    th.join(timeout=5)
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# Selector, session and governed serving
# ---------------------------------------------------------------------------

def _serving_tables(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "orders": {"uid": rng.integers(0, 100_000, n).astype(np.int64),
                   "w": rng.integers(-100, 100, n).astype(np.int64)},
        "users": {"uid": rng.integers(0, 100_000, n).astype(np.int64),
                  "region": rng.integers(0, 10, n).astype(np.int64)},
    }


@pytest.mark.parametrize("agg_col,want_shards", [("w", 8), ("f", 1)])
def test_selector_prices_sharded_like_reference(eight_device_mesh, agg_col,
                                                want_shards):
    rng = np.random.default_rng(17)
    n = 400_000
    build = {"uid": rng.integers(0, 100_000, n).astype(np.int64),
             "region": rng.integers(0, 10, n).astype(np.int64)}
    probe = {"uid": rng.integers(0, 100_000, n).astype(np.int64),
             "w": rng.integers(-100, 100, n).astype(np.int64),
             "f": rng.random(n)}  # float sum: not bit-for-bit shardable
    bj, bt = _both(build)
    pj, pt = _both(probe)
    got = {}
    for M, b, p, kw in ((R, bj, pj, {}), (T, bt, pt, CPU)):
        sel = M.PathSelector(work_mem=4 << 20, **kw)
        spec = M.FusedSpec("uid", M.col("w") > 0, (), (agg_col, "sum"))
        d1 = sel.choose_fragment(spec, b, p)
        d8 = sel.choose_fragment(spec, b, p, max_shards=8)
        got[M.__name__] = (d1.path, d1.shards, d8.path, d8.shards,
                           d8.t_tensor, d8.h2d_bytes, d8.reason)
    assert got["repro_torch.core"] == got["repro.core"]
    assert got["repro_torch.core"][1] == 1
    assert got["repro_torch.core"][3] == want_shards
    if want_shards == 8:
        assert "sharded over 8 lanes" in got["repro_torch.core"][6]


def test_session_sharded_end_to_end(eight_device_mesh):
    tables = _serving_tables(23, 400_000)
    results = {}
    for M, kw in ((R, {}), (T, CPU)):
        for shards in (1, 8):
            sess = M.Session(work_mem=4 << 20, max_shards=shards, **kw)
            for name, cols in tables.items():
                sess.register(name, M.Relation(dict(cols)))
            q = (sess.table("orders").join("users", on="uid")
                 .filter(M.col("w") > 0).aggregate("w", "sum"))
            q.collect()  # cold pass: first call + partition
            results[(M.__name__, shards)] = q.collect()
    for shards in (1, 8):
        ref = results[("repro.core", shards)]
        port = results[("repro_torch.core", shards)]
        assert port.scalar == ref.scalar
        assert ([(d.path, d.shards) for d in port.decisions]
                == [(d.path, d.shards) for d in ref.decisions])
        assert _counters(port.metrics[-1]) == _counters(ref.metrics[-1])
    res = results[("repro_torch.core", 8)]
    assert res.scalar == results[("repro_torch.core", 1)].scalar
    d = res.decisions[-1]
    assert d.path == "tensor" and d.shards == 8
    assert res.metrics[-1].devices == 8
    assert res.metrics[-1].host_syncs == 1
    assert res.total_h2d_bytes == 0


def test_governed_serve_with_lanes(eight_device_mesh):
    tables = _serving_tables(29, 400_000)
    server = T.QueryServer({k: T.Relation(dict(v))
                            for k, v in tables.items()},
                           total_mem=64 << 20, work_mem=8 << 20,
                           max_shards=8, device="cpu")
    assert len(server.broker.lanes) == 8  # pre-created at build
    q = (server.session.table("orders").join("users", on="uid")
         .filter(T.col("w") > 0).aggregate("w", "sum"))
    # no warmup pass: the report then counts the first wave of queries,
    # decided on idle lanes and an empty runtime profile (the model's
    # choice, sharded).  Later decisions feed on observed walls and queue
    # waits; on a loaded CPU those can price the linear or single-device
    # path lower, and a warmup run of a program another test already built
    # feeds its cold partition pass to the profile as a warm wall.
    report = server.serve([q], concurrency=3, queries_per_worker=2,
                          warmup=0)
    assert report.governor.over_budget_events == 0
    assert not report.failed
    assert len(report.broker.lanes) == 8
    # the sharded program fans out across every lane
    assert all(lane["dispatches"] > 0 for lane in report.broker.lanes)
    want = _host_agg(tables["users"], tables["orders"], "uid", "w", "sum",
                     R.col("w") > 0)
    assert {rec.scalar for rec in report.queries} == {want}
    assert server.governor.held_bytes == 0
