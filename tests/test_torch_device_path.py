"""Parity of the port's device layer with the reference: packed layouts
(``codec_device``), the device column cache (``table_cache``), and the
per-operator device operators (``tensor_join_device``,
``tensor_sort_device``, ``group_aggregate_device``).

Both engines get the same numpy inputs and run on the CPU (the port with
``device="cpu"``, its plain kernel versions).  Layout choices, byte counts,
integer outputs and row orders must be equal; float64 aggregates agree
within 1e-9 (rtol and atol, the reference tests' own tolerance).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import codec_device as jcodec  # noqa: E402
from repro.core import table_cache as jcache  # noqa: E402
from repro.core.aggregate import group_aggregate_device as j_group  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import codec_device as tcodec  # noqa: E402
from repro_torch.core import table_cache as tcache  # noqa: E402
from repro_torch.core.aggregate import group_aggregate_device as t_group  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-9


def _both(cols):
    return R.Relation(dict(cols)), T.Relation(dict(cols))


def _same_relation(got, want, exact_order=True):
    assert set(got.names) == set(want.names)
    if not exact_order:
        got, want = got.sort_canonical(), want.sort_canonical()
    for k in want.names:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k


# ---------------------------------------------------------------------------
# Packed layouts and the device column cache
# ---------------------------------------------------------------------------

def _layout_cases():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 60, 100).astype(np.int64)
    kmax = np.iinfo(np.int64).max
    return {
        "dense_for": np.arange(1000, 2000, dtype=np.int64),
        "negative_for": rng.integers(-500, -100, 4096).astype(np.int64),
        "wide_sparse_dict": rng.choice(vals, 50_000),
        "incompressible": rng.integers(0, 1 << 40, 10_000).astype(np.int64),
        "empty": np.zeros(0, np.int64),
        "float": rng.normal(size=300),
        "int8": rng.integers(-9, 9, 300).astype(np.int8),
        "uint64": rng.integers(0, 1 << 20, 300).astype(np.uint64),
        "int32_dates": rng.integers(8035, 10440, 5000).astype(np.int32),
        "two_point_extremes": np.array([-kmax - 1, kmax] * 50, np.int64),
    }


@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_choose_layout_and_codes_match_reference(case):
    col = _layout_cases()[case]
    lay_t, dict_t = tcodec.choose_layout(col)
    lay_j, dict_j = jcodec.choose_layout(col)
    assert dataclasses.asdict(lay_t) == dataclasses.asdict(lay_j)
    assert (dict_t is None) == (dict_j is None)
    if dict_j is not None:
        np.testing.assert_array_equal(dict_t, dict_j)
    codes = tcodec.encode_host(col, lay_t, dict_t)
    np.testing.assert_array_equal(codes,
                                  jcodec.encode_host(col, lay_j, dict_j))
    back = tcodec.decode_host(codes, lay_t, dict_t)
    np.testing.assert_array_equal(back, col)
    if lay_t.encoding == "raw" or len(col) == 0:
        return
    # device decode: torch against jnp, on the same packed codes
    dvals = (None if dict_t is None else tcodec.pad_dictionary(
        dict_t, tcodec.dict_bucket(lay_t.card)))
    got = tcodec.decode_device(
        torch.from_numpy(codes), lay_t.encoding, lay_t.logical_dtype,
        ref=lay_t.ref,
        dict_values=None if dvals is None else torch.from_numpy(dvals))
    want = jcodec.decode_device(
        jnp.asarray(codes), lay_j.encoding, lay_j.logical_dtype,
        ref=lay_j.ref, dict_values=None if dvals is None
        else jnp.asarray(dvals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


def test_decode_device_clamps_out_of_dictionary_codes():
    """Garbage codes (padded / invalid rows) must not become an
    out-of-range gather — on CUDA that is a device assert that poisons the
    context.  They decode to some dictionary value instead."""
    dvals = torch.tensor([10, 20, 30, 30], dtype=torch.int64)
    codes = torch.tensor([0, 3, 127, -1], dtype=torch.int8)
    out = tcodec.decode_device(codes, "dict", "int64", dict_values=dvals)
    assert out.tolist()[:2] == [10, 30]
    assert set(out.tolist()) <= {10, 20, 30}


def _packed_cols(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 50, 40).astype(np.int64)
    return {"dense": np.arange(n, dtype=np.int64) + 7,
            "dict": rng.choice(vals, n),
            "raw": rng.integers(0, 1 << 40, n).astype(np.int64),
            "f": rng.normal(size=n)}


@pytest.mark.parametrize("bucket", [None, 8192])
def test_upload_bytes_cold_then_warm_match_reference(bucket):
    rj, rt = _both(_packed_cols())
    assert (tcache.pending_upload_bytes(rt, bucket, CPU)
            == jcache.pending_upload_bytes(rj, bucket))
    cols_t, phys_t, log_t = tcache.get_device_layouts(rt, bucket, CPU)
    cols_j, phys_j, log_j = jcache.get_device_layouts(rj, bucket)
    assert phys_t > 0 and (phys_t, log_t) == (phys_j, log_j)
    for name, dc in cols_t.items():
        assert dc.layout == dc.layout.__class__(**dataclasses.asdict(
            cols_j[name].layout))
        np.testing.assert_array_equal(dc.codes.numpy(),
                                      np.asarray(cols_j[name].codes))
    # warm: nothing moves, in either engine
    _, phys_t2, log_t2 = tcache.get_device_layouts(rt, bucket, CPU)
    _, phys_j2, log_j2 = jcache.get_device_layouts(rj, bucket)
    assert (phys_t2, log_t2) == (phys_j2, log_j2) == (0, 0)
    assert tcache.pending_upload_bytes(rt, bucket, CPU) == 0


def test_device_cache_keys_on_the_device():
    """An upload for one device is not a hit for another."""
    _, rt = _both(_packed_cols(512))
    tcache.get_device_layouts(rt, None, CPU)
    assert tcache.pending_upload_bytes(rt, None, CPU) == 0
    assert tcache.pending_upload_bytes(rt, None, "cuda") > 0


# ---------------------------------------------------------------------------
# Per-operator device operators (cases of test_core_join / _sort /
# test_aggregate)
# ---------------------------------------------------------------------------

def _join_tables(rng, n_build, n_probe, domain):
    return ({"k": rng.integers(0, domain, n_build).astype(np.int64),
             "v": rng.integers(0, 1 << 30, n_build).astype(np.int64)},
            {"k": rng.integers(0, domain, n_probe).astype(np.int64),
             "w": rng.integers(0, 1 << 30, n_probe).astype(np.int64)})


@pytest.mark.parametrize("n_build,n_probe,domain", [
    (1000, 3000, 5000),      # mostly unique build keys
    (5000, 5000, 50),        # heavy duplicates
    (1, 10, 1),              # degenerate
    (4096, 0, 100),          # empty probe
])
@pytest.mark.parametrize("masked", [False, True])
def test_tensor_join_device_matches_reference(n_build, n_probe, domain,
                                              masked):
    rng = np.random.default_rng(42)
    b, p = _join_tables(rng, n_build, n_probe, domain)
    bj, bt = _both(b)
    pj, pt = _both(p)
    dbj, dpj = R.DeviceRelation.from_host(bj), R.DeviceRelation.from_host(pj)
    dbt = T.DeviceRelation.from_host(bt, CPU)
    dpt = T.DeviceRelation.from_host(pt, CPU)
    if masked and n_probe:
        # masked-out rows must never match (dead-key sentinels), also when
        # their keys collide with live ones
        mb, mp = rng.random(n_build) < 0.7, rng.random(n_probe) < 0.6
        dbj, dpj = dbj.mask_and(jnp.asarray(mb)), dpj.mask_and(jnp.asarray(mp))
        dbt = dbt.mask_and(torch.from_numpy(mb))
        dpt = dpt.mask_and(torch.from_numpy(mp))
    out_j, m_j = R.tensor_join_device(dbj, dpj, "k")
    out_t, m_t = T.tensor_join_device(dbt, dpt, "k")
    assert m_t.host_syncs == m_j.host_syncs
    assert m_t.rows_out == m_j.rows_out
    _same_relation(out_t.to_host(), out_j.to_host())


@pytest.mark.parametrize("case", ["permutation", "offset", "sparse_probe",
                                  "masked", "hidden_duplicate"])
def test_dense_device_join_equals_reference_sorted_join(case, monkeypatch):
    """``tensor_join_device(dense=...)``, the route of a build side whose
    keys the host knows to be unique in a narrow range (a guard's takeover
    of a star join), runs the join kernels' table build and probe and gives
    the reference's sorted-core rows in the same order, with its one host
    sync.  A build key that repeats after all (a sketch's wrong guess) is
    caught by the device's duplicate flag and re-runs the sorted core: the
    same rows, one sync more."""
    import repro_torch.core.fused as F

    calls = []
    real = F.radix_hash_probe_dispatch

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(F, "radix_hash_probe_dispatch", spy)
    rng = np.random.default_rng(8)
    n = 3000
    kmin = 1000 if case == "offset" else 0
    b = {"k": rng.permutation(n).astype(np.int64) + kmin,
         "v": rng.integers(0, 1 << 30, n).astype(np.int64)}
    hi = 4 * n if case == "sparse_probe" else n
    p = {"k": rng.integers(-5, hi, 5000).astype(np.int64) + kmin,
         "w": rng.integers(0, 1 << 30, 5000).astype(np.int64)}
    if case == "hidden_duplicate":
        b["k"][7] = b["k"][8]
    bj, bt = _both(b)
    pj, pt = _both(p)
    dense = T.tensor_engine.dense_join_domain(bt, "k")
    if case == "hidden_duplicate":
        assert dense is None  # the sketch sees every row here: no guess
        dense = (T.capacity_bucket(n), kmin)
    assert dense == (T.capacity_bucket(n), kmin)
    dbj, dpj = R.DeviceRelation.from_host(bj), R.DeviceRelation.from_host(pj)
    dbt = T.DeviceRelation.from_host(bt, CPU)
    dpt = T.DeviceRelation.from_host(pt, CPU)
    if case == "masked":
        mb, mp = rng.random(n) < 0.7, rng.random(5000) < 0.6
        dbj, dpj = dbj.mask_and(jnp.asarray(mb)), dpj.mask_and(jnp.asarray(mp))
        dbt = dbt.mask_and(torch.from_numpy(mb))
        dpt = dpt.mask_and(torch.from_numpy(mp))
    out_j, m_j = R.tensor_join_device(dbj, dpj, "k")
    out_t, m_t = T.tensor_join_device(dbt, dpt, "k", dense=dense)
    assert calls == [dense[0]]
    assert m_t.host_syncs == m_j.host_syncs + (case == "hidden_duplicate")
    assert m_t.rows_out == m_j.rows_out
    _same_relation(out_t.to_host(), out_j.to_host())


@pytest.mark.parametrize("n_build,n_probe,domain", [(1000, 3000, 5000),
                                                    (300, 700, 17)])
def test_tensor_join_host_api_and_capacity_match_reference(n_build, n_probe,
                                                           domain):
    rng = np.random.default_rng(7)
    b, p = _join_tables(rng, n_build, n_probe, domain)
    bj, bt = _both(b)
    pj, pt = _both(p)
    out_t, m_t = T.tensor_join(bt, pt, "k", device="cpu")
    out_j, m_j = R.tensor_join(bj, pj, "k")
    _same_relation(out_t, out_j)
    assert (m_t.host_syncs, m_t.h2d_bytes) == (m_j.host_syncs, m_j.h2d_bytes)
    assert (T.join_capacity(b["k"], p["k"], device="cpu")
            == R.join_capacity(b["k"], p["k"]))
    with pytest.raises(ValueError, match="capacity"):
        T.tensor_join(bt, pt, "k", capacity=16, device="cpu")


def test_tensor_join_aggregate_matches_reference():
    rng = np.random.default_rng(9)
    b = {"k": rng.integers(0, 128, 2048).astype(np.int64),
         "v": rng.integers(0, 50, 2048).astype(np.float64)}
    p = {"k": rng.integers(0, 128, 4096).astype(np.int64),
         "w": rng.normal(size=4096)}
    (bj, bt), (pj, pt) = _both(b), _both(p)
    got, m_t = T.tensor_join_aggregate(bt, pt, "k", "v", "w", 128,
                                       device="cpu")
    want, m_j = R.tensor_join_aggregate(bj, pj, "k", "v", "w", 128)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    assert m_t.h2d_bytes == m_j.h2d_bytes


def _sort_rel(rng, n, domains):
    cols = {f"k{i}": rng.integers(0, d, n).astype(np.int64)
            for i, d in enumerate(domains)}
    cols["payload"] = rng.integers(0, 1 << 40, n).astype(np.int64)
    return cols


@pytest.mark.parametrize("domains", [(1000,), (40, 1 << 35), (8, 8, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_tensor_sort_device_matches_reference(domains, masked):
    """Stable LSD passes: the exact row order (ties included) is the
    reference's."""
    rng = np.random.default_rng(3)
    cols = _sort_rel(rng, 5000, domains)
    keys = [f"k{i}" for i in range(len(domains))]
    rj, rt = _both(cols)
    dj = R.DeviceRelation.from_host(rj)
    dt = T.DeviceRelation.from_host(rt, CPU)
    if masked:
        keep = rng.random(5000) < 0.5
        dj, dt = dj.mask_and(jnp.asarray(keep)), dt.mask_and(
            torch.from_numpy(keep))
    out_j, m_j = R.tensor_sort_device(dj, keys)
    out_t, m_t = T.tensor_sort_device(dt, keys)
    assert m_t.host_syncs == m_j.host_syncs == 0
    _same_relation(out_t.to_host(), out_j.to_host())
    host_t, _ = T.tensor_sort(rt, keys, device="cpu")
    host_j, _ = R.tensor_sort(rj, keys)
    _same_relation(host_t, host_j)


AGGS = {"v": "sum", "w": "min", "u": "max", "c": "count"}


def _agg_cols(rng, n, domain):
    return {"k": rng.integers(0, domain, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64),
            "w": rng.integers(-1000, 1000, n).astype(np.int64),
            "u": rng.integers(-1000, 1000, n).astype(np.int64),
            "c": np.ones(n, np.int64)}


@pytest.mark.parametrize("n,domain", [(20_000, 64), (20_000, 15_000), (1, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_group_aggregate_device_matches_reference(n, domain, masked):
    rng = np.random.default_rng(0)
    cols = _agg_cols(rng, n, domain)
    rj, rt = _both(cols)
    dj = R.DeviceRelation.from_host(rj)
    dt = T.DeviceRelation.from_host(rt, CPU)
    if masked:
        keep = rng.random(n) < 0.5
        keep[0] = True
        dj, dt = dj.mask_and(jnp.asarray(keep)), dt.mask_and(
            torch.from_numpy(keep))
    out_j, _ = j_group(dj, "k", AGGS)
    out_t, m_t = t_group(dt, "k", AGGS)
    assert m_t.host_syncs == 0
    hj, ht = out_j.to_host(), out_t.to_host()
    assert set(ht.names) == set(hj.names)
    np.testing.assert_array_equal(ht["k"], hj["k"])
    for name in hj.names:
        assert ht[name].dtype == hj[name].dtype, name
        np.testing.assert_allclose(ht[name], hj[name], rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_group_aggregate_device_packed_key_and_dtype_max():
    """Code-domain factorization of a packed key, and a live row keyed at
    int64 max beside masked rows (the sentinel-collision regression)."""
    kmax = np.iinfo(np.int64).max
    cols = {"k": np.array([5, 7, kmax, 5], np.int64),
            "v": np.array([1, 999, 100, 2], np.int64)}
    keep = np.array([True, False, True, True])
    rj, rt = _both(cols)
    hj = j_group(R.DeviceRelation.from_host(rj).mask_and(jnp.asarray(keep)),
                 "k", {"v": "sum"})[0].to_host()
    ht = t_group(T.DeviceRelation.from_host(rt, CPU).mask_and(
        torch.from_numpy(keep)), "k", {"v": "sum"})[0].to_host()
    _same_relation(ht, hj)
    # packed (FOR-coded) key straight from the column cache
    rng = np.random.default_rng(4)
    cols = {"k": rng.integers(100, 160, 3000).astype(np.int64),
            "v": rng.integers(0, 9, 3000).astype(np.int64)}
    rj, rt = _both(cols)
    codes_t, _, _ = tcache.get_device_layouts(rt, None, CPU)
    codes_j, _, _ = jcache.get_device_layouts(rj, None)
    assert codes_t["k"].encoding == "for"
    ht = t_group(T.DeviceRelation.from_codes(codes_t), "k",
                 {"v": "sum"})[0].to_host()
    hj = j_group(R.DeviceRelation.from_codes(codes_j), "k",
                 {"v": "sum"})[0].to_host()
    _same_relation(ht, hj)


def test_group_aggregate_tensor_host_api_matches_reference():
    rng = np.random.default_rng(2)
    cols = _agg_cols(rng, 3000, 40)
    rj, rt = _both(cols)
    ht, m_t = T.group_aggregate_tensor(rt, "k", AGGS, device="cpu")
    hj, m_j = R.group_aggregate_tensor(rj, "k", AGGS)
    assert m_t.host_syncs == m_j.host_syncs
    for name in hj.names:
        np.testing.assert_allclose(ht[name], hj[name], rtol=TOL, atol=TOL)
