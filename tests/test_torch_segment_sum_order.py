"""The order of the float64 segment sum: the target the card's kernel is
held to.

The reference's ``jax.ops.segment_sum`` (under x64), the port's plain
version ``segment_sum_ref`` (``index_add_`` on the CPU) and a loop that adds
each segment's values in ascending row order from +0.0 give the same bits
on random float64 values, sorted ids or not; another order (reversed rows)
gives other bits on the same data, so the check can fail.
``tests/test_torch_cuda.py`` holds the card's kernel to the plain version
bit for bit.  The GROUP BY tells the kernel that its ids are sorted (each
segment one run), and the join aggregate does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's float64 policy: x64 on)
from repro_torch.core import Session  # noqa: E402
from repro_torch.core import tensor_engine  # noqa: E402
from repro_torch.kernels.segment_join import ops, ref  # noqa: E402


def _data(n, S, order, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, S + 2, n)
    if order == "sorted":
        ids = np.sort(ids)
    elif order == "skewed":   # half the rows in one segment, unsorted
        ids[rng.permutation(n)[: n // 2]] = S // 3
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-6, 7, n)
    return ids.astype(np.int32), vals


def _row_order(ids, vals, S):
    out = [0.0] * S
    for s, v in zip(ids.tolist(), vals.tolist()):
        if 0 <= s < S:
            out[s] = out[s] + v
    return np.array(out, dtype=np.float64)


@pytest.mark.parametrize("order", ["sorted", "unsorted", "skewed"])
@pytest.mark.parametrize("n,S", [(60_000, 7), (60_000, 3000), (777, 50)])
def test_reference_plain_version_and_row_order_agree_bit_for_bit(order, n,
                                                                 S):
    ids, vals = _data(n, S, order, n + S)
    loop = _row_order(ids, vals, S)
    plain = ref.segment_sum_ref(torch.from_numpy(ids),
                                torch.from_numpy(vals), S).numpy()
    assert jax.config.jax_enable_x64
    jaxs = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), S))
    assert jaxs.dtype == np.float64
    np.testing.assert_array_equal(plain.view(np.int64), loop.view(np.int64))
    np.testing.assert_array_equal(jaxs.view(np.int64), loop.view(np.int64))
    if n > 1000:  # the data is such that the order shows in the bits
        rev = _row_order(ids[::-1], vals[::-1], S)
        assert not np.array_equal(rev.view(np.int64), loop.view(np.int64))


@pytest.mark.parametrize("ids_sorted", [False, True])
def test_ops_segment_sum_gives_the_row_order_bits(ids_sorted):
    """The op the engine calls, on the CPU, with the ids sorted or in a
    shuffled row order: the row-order bits."""
    ids, vals = _data(20_000, 300, "sorted", 3)
    if not ids_sorted:
        perm = np.random.default_rng(4).permutation(ids.size)
        ids, vals = ids[perm], vals[perm]
    got = ops.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals),
                          300).numpy()
    np.testing.assert_array_equal(got.view(np.int64),
                                  _row_order(ids, vals, 300).view(np.int64))


def test_group_by_says_its_ids_are_sorted_and_join_aggregate_does_not(
        monkeypatch):
    """The GROUP BY hands the kernel ids that never decrease (the card
    then chains their runs as they come, where the sum is not exact in
    every order); the join aggregate's ids are unsorted."""
    calls = []
    real = tensor_engine.segment_sum_dispatch

    def spy(values, seg_ids, num_segments):
        calls.append(seg_ids.clone())
        return real(values, seg_ids, num_segments)

    monkeypatch.setattr(tensor_engine, "segment_sum_dispatch", spy)
    rng = np.random.default_rng(5)
    n = 5000
    sess = Session(work_mem=1 << 20, policy="tensor", device="cpu")
    sess.register("t", {"g": rng.integers(0, 90, n).astype(np.int64),
                        "w": rng.normal(size=n),
                        "c": rng.integers(0, 9, n).astype(np.int64)})
    res = sess.table("t").group_by("g", {"w": "sum", "c": "count"}).collect()
    assert res.relation is not None and len(calls) == 2
    for seg in calls:
        assert bool((seg[1:] >= seg[:-1]).all())
    calls.clear()
    keys = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=400))
    tensor_engine._join_aggregate(keys, vals, keys.flip(0), vals, 50)
    assert len(calls) == 4
    assert not any(bool((seg[1:] >= seg[:-1]).all()) for seg in calls)
