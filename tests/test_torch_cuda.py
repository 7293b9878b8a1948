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
                                                      "ok": "count"})}
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
