"""The port's sharded fragment with its partitions placed on several
devices, against the reference's ``shard_map`` program, on the CPU.

The reference runs ``repro.core.fused.run_fused(..., shards=8)`` under
``shard_map`` on the eight forced host devices of ``tests/conftest.py``
(the ``eight_device_mesh`` fixture), one partition a device.  The port
places the same eight partitions on ``("cpu",) * k`` for k in 1, 2, 3 and 8
in contiguous blocks (``distributed.sharding.partition_placement``, the
CPU's analogue of k cards): each block runs as one batched program on its
device and the blocks' partials are combined on the first.  Every
placement must give the reference's scalar bit for bit, its counters
(``host_syncs``, ``devices``, ``h2d_bytes``, ``h2d_bytes_logical``,
``peak_working_set_bytes``) and the port's one-device run; a warm run
makes one host sync and uploads nothing.  Each reference result is built
once per module and shared by the placements.
"""
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

PLACEMENTS = (1, 2, 3, 8)
SHARDS = 8
CASE_SEEDS = {"sum": 7, "count": 8, "min": 9, "max": 10, "u32sum": 11,
              "u32max": 12, "zipf": 13, "empty": 14}


def _cpus(k):
    return ("cpu",) * k


def _counters(m):
    return (m.host_syncs, m.devices, m.h2d_bytes, m.h2d_bytes_logical,
            m.peak_working_set_bytes, m.rows_out, m.path, m.op)


def _tables(case):
    """``(build, probe, agg, filtered)`` of one case, from its own seed."""
    rng = np.random.default_rng(CASE_SEEDS[case])
    n_b, n_p = 20_000, 30_000
    if case == "zipf":
        n_b = n_p = 1_500
        build = {"uid": np.minimum(rng.zipf(1.3, n_b), 1 << 40)
                 .astype(np.int64),
                 "region": rng.integers(0, 4, n_b).astype(np.int64)}
        probe = {"uid": np.minimum(rng.zipf(1.3, n_p), 1 << 40)
                 .astype(np.int64),
                 "w": rng.integers(-50, 50, n_p).astype(np.int64)}
        return build, probe, ("w", "sum"), True
    if case == "empty":
        # one distinct key: every row in one partition, the other seven
        # run over all-sentinel padding and contribute identities
        build = {"uid": np.full(500, 42, np.int64),
                 "region": rng.integers(0, 4, 500).astype(np.int64)}
        probe = {"uid": np.full(100, 42, np.int64),
                 "w": rng.integers(1, 9, 100).astype(np.int64)}
        return build, probe, ("w", "max"), False
    build = {"uid": rng.integers(-5_000, 5_000, n_b).astype(np.int64),
             "region": rng.integers(0, 10, n_b).astype(np.int64),
             "u32": rng.integers(1 << 30, 1 << 32, n_b,
                                 dtype=np.uint64).astype(np.uint32)}
    probe = {"uid": rng.integers(-5_000, 5_000, n_p).astype(np.int64),
             "w": rng.integers(-100, 100, n_p).astype(np.int64)}
    agg = {"sum": ("w", "sum"), "count": ("w", "count"),
           "min": ("b_region", "min"), "max": ("w", "max"),
           "u32sum": ("b_u32", "sum"), "u32max": ("b_u32", "max")}[case]
    return build, probe, agg, case in ("sum", "count", "min")


#: (case, device codecs): compressed and plain columns for the cases that
#: read a payload the codecs pack; the rest under the default
CASES = [("sum", "on"), ("sum", "off"), ("min", "on"), ("min", "off"),
         ("count", "on"), ("max", "off"), ("u32sum", "on"),
         ("u32max", "off"), ("zipf", "on"), ("empty", "on")]


def _spec(M, agg, filtered):
    return M.FusedSpec(join_key="uid",
                       filter_fn=(M.col("w") > 0) if filtered else None,
                       sort_keys=(), agg=agg)


def _forget_capacities():
    """Both engines' verified-capacity hints, keyed by a column's buffer
    address among others: a fresh table at a reused address would find
    another table's hint, so each cold run starts without any."""
    jfused._CAP_HINTS.clear()
    tfused._CAP_HINTS.clear()


@pytest.fixture(scope="module")
def built():
    """Results shared by the module's placements: per (case, codecs), the
    reference's cold and warm runs and the port's one-device run."""
    return {}


def _reference(built, case, compress):
    key = (case, compress)
    if key not in built:
        build, probe, agg, filtered = _tables(case)
        bj, pj = R.Relation(dict(build)), R.Relation(dict(probe))
        _forget_capacities()
        ref = [jfused.run_fused(_spec(R, agg, filtered), bj, pj,
                                shards=SHARDS) for _ in range(2)]
        _forget_capacities()
        one = tfused.run_fused(_spec(T, agg, filtered), T.Relation(build),
                               T.Relation(probe), shards=SHARDS,
                               device="cpu")
        host = host_agg(R.Relation(build), R.Relation(probe), "uid",
                        agg[0], agg[1],
                        (R.col("w") > 0) if filtered else None)
        built[key] = (ref, one, host)
    return built[key]


@pytest.mark.parametrize("k", PLACEMENTS)
@pytest.mark.parametrize("case,compress", CASES)
def test_placement_matches_reference(eight_device_mesh, built, monkeypatch,
                                     case, compress, k):
    monkeypatch.setenv("REPRO_DEVICE_COMPRESS",
                       "1" if compress == "on" else "0")
    (ref_cold, ref_warm), one, host = _reference(built, case, compress)
    build, probe, agg, filtered = _tables(case)
    bt, pt = T.Relation(build), T.Relation(probe)
    _forget_capacities()
    runs = [tfused.run_fused(_spec(T, agg, filtered), bt, pt, shards=SHARDS,
                             device=_cpus(k)) for _ in range(2)]
    (cold, mc), (warm, mw) = runs
    assert cold == warm == ref_cold[0] == one[0] == host  # bit for bit
    assert _counters(mc) == _counters(ref_cold[1]) == _counters(one[1])
    assert _counters(mw) == _counters(ref_warm[1])
    assert mc.devices == SHARDS and mc.h2d_bytes > 0
    assert (mw.host_syncs, mw.h2d_bytes) == (1, 0)
    # the layout is resident in k blocks on the placement's devices
    placement = tsharding.partition_placement(SHARDS, _cpus(k))
    blocks = tpart.get_placed_columns(bt, "uid", True, placement)[0]
    assert [c["uid"].shape[0] for c, _, _ in blocks] == [
        hi - lo for _, lo, hi in placement.groups]


def test_placement_blocks():
    P = tsharding.partition_placement
    cpu = torch.device("cpu")
    assert P(8, _cpus(4)).bounds == (0, 2, 4, 6, 8)
    assert P(8, _cpus(2)).bounds == (0, 4, 8)
    assert P(3, _cpus(2)).bounds == (0, 2, 3)
    assert P(8, _cpus(3)).bounds == (0, 3, 6, 8)
    # never more blocks than partitions
    assert P(2, _cpus(4)).devices == (cpu, cpu)
    assert P(8, "cpu").groups == ((cpu, 0, 8),)
    assert P(8, "cpu").key == (("cpu", 0, 8),)
    assert tsharding.placement_devices("cpu") == (cpu,)
    assert tsharding.placement_devices(["cpu", "meta"]) == (
        cpu, torch.device("meta"))
    placement = P(8, _cpus(3))
    assert P(8, placement) is placement
    with pytest.raises(ValueError):
        P(4, placement)
    with pytest.raises(ValueError):
        P(0, "cpu")
    with pytest.raises(ValueError):
        tsharding.placement_devices(())
    # a card that is not there raises; nothing falls back to the others
    missing = f"cuda:{torch.cuda.device_count() + 3}"
    with pytest.raises(RuntimeError):
        tsharding.placement_devices(("cpu", missing))
    with pytest.raises(RuntimeError):
        T.Session(max_shards=8, device=("cpu", missing))


def test_placed_layout_is_the_reference_layout_in_blocks(eight_device_mesh):
    import jax

    rng = np.random.default_rng(19)
    n = 9_000
    cols = {"uid": rng.integers(-3_000, 3_000, n).astype(np.int64),
            "small": rng.integers(0, 7, n).astype(np.int64),
            "f": rng.random(n)}
    rj, rt = R.Relation(dict(cols)), T.Relation(dict(cols))
    want = jpart.get_partitioned_columns(rj, "uid", SHARDS, True)
    placement = tsharding.partition_placement(SHARDS, _cpus(3))
    blocks, counts, bucket, up, log, lay = tpart.get_placed_columns(
        rt, "uid", True, placement)
    assert (bucket, up, log) == want[3:6]
    np.testing.assert_array_equal(counts, want[2])
    for name in want[0]:
        joined = np.concatenate([c[name].numpy() for c, _, _ in blocks])
        np.testing.assert_array_equal(joined, jax.device_get(want[0][name]))
    np.testing.assert_array_equal(
        np.concatenate([n.numpy() for _, n, _ in blocks]), want[2])
    for name in want[7]:  # every block decodes against the whole dictionary
        for _, _, dicts in blocks:
            np.testing.assert_array_equal(dicts[name].numpy(),
                                          jax.device_get(want[7][name]))


def test_partition_cache_keys_on_the_placement(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_COMPRESS", "0")  # no dictionaries
    rng = np.random.default_rng(23)
    rel = T.Relation({"uid": rng.integers(0, 500, 3_000).astype(np.int64),
                      "w": rng.integers(0, 5, 3_000).astype(np.int64)})
    two = tsharding.partition_placement(SHARDS, _cpus(2))
    four = tsharding.partition_placement(SHARDS, _cpus(4))
    first = tpart.get_placed_columns(rel, "uid", True, two)
    assert first[3] > 0
    assert tpart.pending_partition_bytes(rel, "uid", SHARDS, True, two) == 0
    # a 2-group layout is not served to a 4-group query
    assert (tpart.pending_partition_bytes(rel, "uid", SHARDS, True, four)
            == first[3])
    again = tpart.get_placed_columns(rel, "uid", True, four)
    assert again[3] == first[3] and len(again[0]) == 4
    assert tpart.get_placed_columns(rel, "uid", True, two)[3] == 0
    # the one-device call and a one-group placement share an entry
    one = tpart.get_partitioned_columns(rel, "uid", SHARDS, True, "cpu")
    assert one[4] == first[3]
    single = tsharding.partition_placement(SHARDS, "cpu")
    assert tpart.get_placed_columns(rel, "uid", True, single)[3] == 0
    resident = tpart.resident_partition_bytes(rel)
    assert set(resident) == {"cpu"}
    assert resident["cpu"] == 3 * first[3]


def test_capacity_overflow_retries_once_on_a_placement(eight_device_mesh):
    # one hot key with 500 build-side duplicates: the optimistic capacity
    # overflows in one partition of one block, and the run loop retries
    # once at the exact bucket, as the reference does
    rng = np.random.default_rng(13)
    build_keys = np.concatenate([np.arange(1_000, 2_500, dtype=np.int64),
                                 np.full(500, 7, np.int64)])
    build = {"uid": build_keys,
             "region": rng.integers(0, 3, len(build_keys)).astype(np.int64)}
    probe = {"uid": np.full(200, 7, np.int64), "w": np.ones(200, np.int64)}
    spec = _spec(R, ("w", "count"), False)
    bj, pj = R.Relation(dict(build)), R.Relation(dict(probe))
    _forget_capacities()
    ref = [jfused.run_fused(spec, bj, pj, shards=SHARDS) for _ in range(2)]
    bt, pt = T.Relation(dict(build)), T.Relation(dict(probe))
    _forget_capacities()
    port = [tfused.run_fused(_spec(T, ("w", "count"), False), bt, pt,
                             shards=SHARDS, device=_cpus(3))
            for _ in range(2)]
    for (rj, mj), (rt, mt) in zip(ref, port):
        assert rt == rj == 200.0 * 500.0
        assert _counters(mt) == _counters(mj)
    assert [m.host_syncs for _, m in port] == [2, 1]


def test_session_over_a_tuple_of_devices():
    """A session over three devices decides, answers and counts as one
    over a single device (``tests/test_torch_sharded.py`` holds the
    latter against the reference's session)."""
    rng = np.random.default_rng(29)
    n = 200_000
    tables = {"orders": {"uid": rng.integers(0, 100_000, n).astype(np.int64),
                         "w": rng.integers(-100, 100, n).astype(np.int64)},
              "users": {"uid": rng.integers(0, 100_000, n).astype(np.int64),
                        "region": rng.integers(0, 10, n).astype(np.int64)}}
    results = {}
    for device in ("cpu", _cpus(3)):
        _forget_capacities()
        sess = T.Session(work_mem=4 << 20, max_shards=SHARDS, device=device)
        for name, cols in tables.items():
            sess.register(name, T.Relation(dict(cols)))
        q = (sess.table("orders").join("users", on="uid")
             .filter(T.col("w") > 0).aggregate("w", "sum"))
        results[device] = (q.collect(), q.collect())
    for one, three in zip(results["cpu"], results[_cpus(3)]):
        assert three.scalar == one.scalar
        assert ([(d.path, d.shards) for d in three.decisions]
                == [(d.path, d.shards) for d in one.decisions])
        assert _counters(three.metrics[-1]) == _counters(one.metrics[-1])
    warm = results[_cpus(3)][1]
    assert warm.decisions[-1].shards == SHARDS
    assert (warm.total_host_syncs, warm.total_h2d_bytes) == (1, 0)
    assert warm.scalar == host_agg(
        R.Relation(tables["users"]), R.Relation(tables["orders"]), "uid",
        "w", "sum", R.col("w") > 0)
