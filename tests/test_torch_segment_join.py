"""Parity of the port's segment_join ops (``repro_torch.kernels.segment_join``)
with the reference's (``repro.kernels.segment_join``).

On the CPU the port's ops take their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode and its jnp oracles.  Inputs are
made with numpy from fixed seeds and handed to both.  Integer outputs must
be equal; float64 sums agree within rtol 1e-12 (a different summation
order is the only difference allowed).  The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py`` and
by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's float64 policy: x64 on)
from repro.kernels.segment_join import kernel as jk  # noqa: E402
from repro.kernels.segment_join import ops as jops  # noqa: E402
from repro.kernels.segment_join import ref as jref  # noqa: E402
from repro_torch.kernels.segment_join import ops, ref  # noqa: E402

RTOL = 1e-12


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(
        a if dtype is None else np.asarray(a, dtype)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,tblk", [
    (2048, 64, 512),
    (1000, 64, 256),     # n not a multiple of the tile: padded tail
    (4096, 4096, 1024),  # the reference's largest one-hot width
    (1, 1, 2048),
    (0, 8, 2048),        # empty input
])
def test_segment_sum_matches_reference(n, S, tblk):
    rng = np.random.default_rng(n + S)
    seg = rng.integers(0, S, n).astype(np.int32)
    val = rng.normal(size=n)
    got = ops.segment_sum(_t(seg), _t(val), S)
    want = jops.segment_sum(jnp.asarray(seg), jnp.asarray(val), S,
                            tblk=tblk, interpret=True)
    oracle = jref.segment_sum_ref(jnp.asarray(seg), jnp.asarray(val), S)
    assert got.dtype == torch.float64 and got.shape == (S,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=RTOL,
                               atol=1e-12)


def test_segment_sum_drops_out_of_range_ids():
    """Ids outside [0, S) contribute nothing (jax.ops.segment_sum's rule);
    the port must not raise on them either."""
    rng = np.random.default_rng(3)
    seg = rng.integers(-5, 40, 3000).astype(np.int32)
    val = rng.normal(size=3000)
    got = ops.segment_sum(_t(seg), _t(val), 32)
    want = jref.segment_sum_ref(jnp.asarray(seg), jnp.asarray(val), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-12)


def test_segment_sum_keeps_float64():
    """No float32 downcast: a sum that needs more than 24 bits stays
    exact."""
    seg = np.zeros(2, np.int32)
    val = np.array([1.0, 2.0**-30])
    got = ops.segment_sum(_t(seg), _t(val), 1)
    assert got.dtype == torch.float64
    assert float(got[0]) == 1.0 + 2.0**-30


def test_join_aggregate_kernel_matches_reference():
    rng = np.random.default_rng(9)
    nb, npr, dom = 2048, 4096, 128
    bk = rng.integers(0, dom, nb).astype(np.int32)
    pk = rng.integers(0, dom, npr).astype(np.int32)
    bv = rng.integers(0, 50, nb).astype(np.float64)
    pv = rng.integers(0, 50, npr).astype(np.float64)
    got = ops.join_aggregate_kernel(_t(bk), _t(bv), _t(pk), _t(pv), dom)
    want = jops.join_aggregate_kernel(jnp.asarray(bk), jnp.asarray(bv),
                                      jnp.asarray(pk), jnp.asarray(pv), dom,
                                      interpret=True)
    for k in ("count", "sum_prod", "sum_add"):
        # integer-valued float64 sums far below 2**53: exact
        assert float(got[k]) == float(want[k]), k


# ---------------------------------------------------------------------------
# radix rank / partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nbuckets,tblk", [
    (1000, 8, 256),        # non-pow2 n
    (2048, 64, 512),
    (4096, 1, 1024),       # single bucket: identity order
    (513, 16, 256),
])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int8])
def test_radix_partition_matches_reference(n, nbuckets, tblk, dtype):
    rng = np.random.default_rng(n + nbuckets)
    hi = min(nbuckets, np.iinfo(dtype).max + 1)
    ids = rng.integers(0, hi, n).astype(dtype)
    dest, counts = ops.radix_partition(_t(ids), nbuckets)
    dest_j, counts_j = jops.radix_partition(jnp.asarray(ids), nbuckets,
                                            tblk=tblk, interpret=True)
    dest_r, counts_r = ref.radix_partition_ref(_t(ids), nbuckets)
    assert dest.dtype == torch.int32 and counts.dtype == torch.int32
    _eq(dest, dest_j)
    _eq(counts, counts_j)
    _eq(dest_r, dest_j)
    _eq(counts_r, counts_j)


def test_radix_partition_empty():
    dest, counts = ops.radix_partition(torch.zeros(0, dtype=torch.int32), 8)
    assert dest.shape == (0,)
    _eq(counts, np.zeros(8, np.int32))


@pytest.mark.parametrize("n,nbuckets,tblk", [(1024, 16, 256),
                                             (2048, 5, 1024)])
def test_radix_rank_out_of_range_ids(n, nbuckets, tblk):
    """Ids outside [0, B) get rank 0 and are not counted — the padding
    contract of radix_rank_pallas, which the port's rank keeps."""
    rng = np.random.default_rng(n)
    ids = rng.integers(-3, nbuckets + 3, n).astype(np.int32)
    rank, counts = ops.radix_rank(_t(ids), nbuckets)
    rank_j, counts_j = jk.radix_rank_pallas(jnp.asarray(ids), nbuckets,
                                            tblk=tblk, interpret=True)
    _eq(rank, rank_j)
    _eq(counts, counts_j)


# ---------------------------------------------------------------------------
# hash-table build / probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dup", [False, True, "dead"])
def test_table_build_and_probe_match_pallas(dup):
    """Codes outside the table (negative, >= domain_pad) are ignored by the
    build and gather 0 in the probe; duplicate build codes keep the largest
    row id + 1.  ``dead``: 28% of the rows at the dead slot ``domain`` (the
    fused join's padding rows), radix-ordered by 512-code block as the
    probe hands them to the build, so they form one run."""
    rng = np.random.default_rng(11 + (dup is True) + 2 * (dup == "dead"))
    n, dpad, tblk, dblk = 1024, 1024, 256, 512
    hi = dpad // 8 if dup is True else dpad + 64
    bk = rng.integers(-16, hi, n).astype(np.int32)
    brow = rng.permutation(n).astype(np.int32)
    if dup == "dead":
        domain = dpad - 100
        bk = rng.integers(0, domain, n).astype(np.int32)
        bk[n - n * 28 // 100:] = domain   # the padding rows come last
        order = np.argsort(bk >> 9, kind="stable")
        bk, brow = bk[order], order.astype(np.int32)
    pk = rng.integers(-16, dpad + 64, n).astype(np.int32)
    cnt, inv = ops.join_table_build(_t(bk), _t(brow), dpad)
    cnt_j, inv_j = jk.join_table_build_pallas(
        jnp.asarray(bk), jnp.asarray(brow), dpad, tblk=tblk, dblk=dblk,
        interpret=True)
    _eq(cnt, cnt_j)
    _eq(inv, inv_j)
    cp, ip = ops.join_table_probe(_t(pk), cnt, inv)
    cp_j, ip_j = jk.join_table_probe_pallas(
        jnp.asarray(pk), cnt_j, inv_j, tblk=tblk, dblk=dblk, interpret=True)
    _eq(cp, cp_j)
    _eq(ip, ip_j)


def _probe_case(nb, npr, domain, seed, dup=False, dead=False):
    """Codes in [0, domain]; slot ``domain`` is the dead/padding slot (the
    case generator of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    hi = domain if not dead else domain + 1
    bk = rng.integers(0, domain, nb) if not dup else \
        rng.integers(0, max(1, domain // 4), nb)
    if not dup and nb <= domain:
        bk = rng.permutation(domain)[:nb]
    pk = rng.integers(0, hi, npr)
    if dead:
        bk[rng.random(nb) < 0.1] = domain
    return bk.astype(np.int32), pk.astype(np.int32)


@pytest.mark.parametrize("nb,npr,domain", [
    (256, 1024, 512),
    (1000, 3000, 1024),     # non-pow2 sizes
    (2048, 2048, 4096),
    (64, 128, 16),          # domain smaller than the radix block
    (300, 700, 40000),      # past the reference's 4096 dense gate
])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("dead", [False, True])
def test_radix_hash_probe_matches_reference(nb, npr, domain, dup, dead):
    bk, pk = _probe_case(nb, npr, domain, nb + npr + domain, dup, dead)
    cnt, row, has_dup = ops.radix_hash_probe(_t(bk), _t(pk), domain)
    cnt_r, row_r, has_dup_r = jref.radix_hash_probe_ref(
        jnp.asarray(bk), jnp.asarray(pk), domain)
    _eq(cnt, cnt_r)
    _eq(row, row_r)
    assert bool(has_dup) == bool(has_dup_r)
    mine = ref.radix_hash_probe_ref(_t(bk), _t(pk), domain)
    _eq(mine[0], cnt_r)
    _eq(mine[1], row_r)
    if (nb, domain) in ((1000, 1024), (64, 16)):
        # the interpret-mode Pallas probe too (slow: two shapes only; the
        # oracle above covers every case)
        cnt_j, row_j, dup_j = jops.radix_hash_probe(
            jnp.asarray(bk), jnp.asarray(pk), domain, interpret=True)
        _eq(cnt, cnt_j)
        _eq(row, row_j)
        assert bool(has_dup) == bool(dup_j)


def _probe_order(pk, domain, dpad, probe, rng):
    """The probe codes of a case in one of the orders and placements the
    radix probe must not depend on."""
    if probe == "in_order":        # as lineitem's l_orderkey comes
        return np.sort(pk)
    if probe == "shuffled":
        return rng.permutation(np.sort(pk))
    if probe == "dead_slot":       # every probe at the dead slot
        return np.full_like(pk, domain)
    if probe == "past_domain":     # codes in (domain, dpad): empty slots
        out = pk.copy()
        out[rng.random(len(pk)) < 0.3] = rng.integers(domain + 1, dpad)
        return out
    raise ValueError(probe)


@pytest.mark.parametrize("probe", ["in_order", "shuffled", "dead_slot",
                                   "past_domain"])
@pytest.mark.parametrize("nb,npr,domain,dup", [
    (256, 1024, 500, False),
    (64, 128, 16, True),           # duplicate build keys
    (300, 700, 40000, False),
])
def test_radix_hash_probe_matches_reference_in_any_probe_order(
        probe, nb, npr, domain, dup):
    """The port probes in the probe side's own row order (one launch on the
    card) where the reference radix-orders it first: the outputs, has_dup
    included, are the JAX radix_hash_probe's (its Pallas kernels in
    interpret mode) with the probes in order, shuffled, all at the dead
    slot, and past the domain inside the padded table."""
    bk, pk = _probe_case(nb, npr, domain, nb + npr + domain, dup, True)
    rng = np.random.default_rng(npr)
    dpad = -(-(domain + 1) // 512) * 512
    pk = _probe_order(pk, domain, dpad, probe, rng).astype(np.int32)
    cnt, row, has_dup = ops.radix_hash_probe(_t(bk), _t(pk), domain)
    cnt_j, row_j, dup_j = jops.radix_hash_probe(
        jnp.asarray(bk), jnp.asarray(pk), domain, interpret=True)
    _eq(cnt, cnt_j)
    _eq(row, row_j)
    assert bool(has_dup) == bool(dup_j)


def test_join_table_probe_rows_is_the_probe_less_one():
    """The row-order probe entry: the count and ``inv - 1``, codes outside
    the table giving (0, -1), against the Pallas probe."""
    rng = np.random.default_rng(17)
    n, dpad, tblk, dblk = 1024, 1024, 256, 512
    bk = rng.integers(0, dpad // 4, n).astype(np.int32)
    brow = rng.permutation(n).astype(np.int32)
    pk = rng.integers(-16, dpad + 64, 1500).astype(np.int32)
    cnt, inv = ops.join_table_build(_t(bk), _t(brow), dpad)
    cp, row = ops.join_table_probe_rows(_t(pk), cnt, inv)
    cnt_j, inv_j = jk.join_table_build_pallas(
        jnp.asarray(bk), jnp.asarray(brow), dpad, tblk=tblk, dblk=dblk,
        interpret=True)
    pk_pad = np.concatenate([pk, np.full(36, -1, np.int32)])  # whole tiles
    cp_j, ip_j = jk.join_table_probe_pallas(
        jnp.asarray(pk_pad), cnt_j, inv_j, tblk=tblk, dblk=dblk,
        interpret=True)
    _eq(cp, np.asarray(cp_j)[:1500])
    _eq(row, np.asarray(ip_j)[:1500] - 1)


@pytest.mark.parametrize("nb,npr", [(0, 256), (256, 0), (0, 0)])
def test_radix_hash_probe_empty_sides(nb, npr):
    rng = np.random.default_rng(7)
    bk = rng.integers(0, 64, nb).astype(np.int32)
    pk = rng.integers(0, 64, npr).astype(np.int32)
    cnt, row, has_dup = ops.radix_hash_probe(_t(bk), _t(pk), 64)
    cnt_j, row_j, dup_j = jops.radix_hash_probe(jnp.asarray(bk),
                                                jnp.asarray(pk), 64,
                                                interpret=True)
    _eq(cnt, cnt_j)
    _eq(row, row_j)
    assert bool(has_dup) == bool(dup_j) is False


def test_radix_hash_probe_dead_slot_is_not_a_duplicate():
    """Every build row at the dead slot: a pile-up there is the caller's
    masking problem, not a live duplicate."""
    domain = 4096
    bk = np.full(512, domain, np.int32)
    pk = np.concatenate([np.full(100, domain, np.int32),
                         np.arange(100, dtype=np.int32)])
    cnt, row, has_dup = ops.radix_hash_probe(_t(bk), _t(pk), domain)
    cnt_j, row_j, dup_j = jops.radix_hash_probe(jnp.asarray(bk),
                                                jnp.asarray(pk), domain,
                                                interpret=True)
    _eq(cnt, cnt_j)
    _eq(row, row_j)
    assert bool(has_dup) is False and bool(dup_j) is False


def test_probe_block_size_bounds_the_radix_buckets():
    assert ops.probe_block_size(1 << 23) == 512   # 16,385 buckets
    dblk = ops.probe_block_size(1 << 26)
    assert -(-((1 << 26) + 1) // dblk) <= ops.MAX_PROBE_BUCKETS


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused."""
    from repro_torch.kernels.segment_join import kernel

    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.segment_sum(seg, torch.zeros(4, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.radix_rank(seg, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.join_table_build(seg, seg, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.join_table_probe(seg, seg, seg)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.join_table_probe_rows(seg, seg, seg)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.segment_sum_route(seg, torch.zeros(4, dtype=torch.float64), 2)
