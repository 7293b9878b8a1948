"""The exact, order-free route of the float64 segment sum.

The card sums a call with atomics, in no fixed order, when
``ref.sum_is_order_free_ref`` holds for its values: every value a multiple
of ``2**e``, no NaN or infinity, and ``2**(top + 1) * 2**ceil(log2 n) <=
min(2**(53 + e), 2**1024)``.  These properties hold the predicate to what
it promises: where it is true, the row-order sum (the reference's bits, as
``jax.ops.segment_sum`` under x64 and the plain version give them) has the
same bits as the sums in reversed, shuffled and pairwise order; where it is
false, an input is named whose orders differ, so the test is not vacuous.
``tests/test_torch_cuda.py`` holds the card to the same bits and checks
that it takes the exact route exactly where the predicate holds.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis; "
                    "pip install -r requirements.txt")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's float64 policy: x64 on)
from repro_torch.kernels.segment_join import ops, ref  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _row_order(ids, vals, S):
    out = [0.0] * S
    for s, v in zip(ids.tolist(), vals.tolist()):
        if 0 <= s < S:
            out[s] = out[s] + v
    return np.array(out, dtype=np.float64)


def _pairwise(xs):
    """A tree over the values: neighbours added pairwise, level by level."""
    xs = list(xs)
    if not xs:
        return 0.0
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] if i + 1 < len(xs) else xs[i]
              for i in range(0, len(xs), 2)]
    return 0.0 + xs[0]


def _orders(ids, vals, S, seed):
    """Each segment's sum in row order, reversed, shuffled and pairwise."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    rows = [[] for _ in range(S)]
    for s, v in zip(ids.tolist(), vals.tolist()):
        if 0 <= s < S:
            rows[s].append(v)
    return {"row": _row_order(ids, vals, S),
            "reversed": _row_order(ids[::-1], vals[::-1], S),
            "shuffled": _row_order(ids[perm], vals[perm], S),
            "pairwise": np.array([_pairwise(r) for r in rows], np.float64)}


def _jax_segment_sum(ids, vals, S):
    assert jax.config.jax_enable_x64
    return np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), S))


def _order_free(vals) -> bool:
    return ref.sum_is_order_free_ref(torch.from_numpy(
        np.asarray(vals, dtype=np.float64)))


def _log2n(n: int) -> int:
    return max(0, math.ceil(math.log2(n))) if n > 1 else 0


@st.composite
def _exact_columns(draw):
    """Columns the predicate accepts: integer cents, counts, multiples of
    2**-k, and integers just under the bound for their length."""
    n = draw(st.integers(1, 400))
    kind = draw(st.sampled_from(["cents", "counts", "pow2", "near_bound"]))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    if kind == "cents":
        vals = rng.integers(-10**9, 10**9, n).astype(np.float64)
    elif kind == "counts":
        vals = rng.integers(0, 2, n).astype(np.float64)
    elif kind == "pow2":
        k = draw(st.integers(1, 60))
        vals = rng.integers(-2**30, 2**30, n).astype(np.float64) * 2.0**-k
    else:   # |x| in [2**(52 - L), 2**(53 - L)): 2**(top + 1) * 2**L = 2**53
        L = _log2n(n)
        vals = (rng.integers(2**(52 - L), 2**(53 - L), n)
                * rng.choice([-1, 1], n)).astype(np.float64)
    S = draw(st.integers(1, 40))
    ids = rng.integers(-2, S + 2, n).astype(np.int32)
    if draw(st.booleans()):
        ids = np.sort(ids)
    return kind, ids, vals, S, seed


@settings(max_examples=120, deadline=None)
@given(_exact_columns())
def test_where_the_predicate_holds_every_order_has_the_row_order_bits(case):
    kind, ids, vals, S, seed = case
    assert _order_free(vals), kind
    sums = _orders(ids, vals, S, seed)
    want = _bits(sums["row"])
    for order, got in sums.items():
        np.testing.assert_array_equal(_bits(got), want, err_msg=order)
    np.testing.assert_array_equal(_bits(_jax_segment_sum(ids, vals, S)), want)
    plain = ops.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), S)
    np.testing.assert_array_equal(_bits(plain.numpy()), want)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 1000, 4096, 4097])
def test_predicate_at_the_bound_on_both_sides(n):
    """n values of 2**(52 - L) .. 2**(53 - L) - 1 (L = ceil(log2 n)), one
    of them odd, sit on the bound and are exact; one value of 2**(53 - L)
    is past it.  A single finite value is always its own exact sum."""
    L = _log2n(n)
    rng = np.random.default_rng(n)
    under = rng.integers(2**(52 - L), 2**(53 - L), n).astype(np.float64)
    under[0] = 2.0**(52 - L) + 1.0
    assert _order_free(under)
    assert _order_free(under[n // 2:n // 2 + 1] * 2.0)
    past = under.copy()
    past[n // 2] = 2.0**(53 - L)
    assert not _order_free(past)
    # a power of two shifts the lowest bit with the top one: still exact
    assert _order_free(np.full(n, 2.0**(60 - L)))


@pytest.mark.parametrize("vals", [
    [0.1, 0.2, 0.3],                 # non-integers
    [2.0**53, 1.0, 1.0],             # one value past the bound
    [1.0, 2.0**-60, -1.0, 2.0**-60],
    [1e308, 1e308, -1e308],          # the overflow guard
], ids=["tenths", "past_2_53", "low_bits", "overflow"])
def test_where_the_predicate_fails_an_order_changes_the_bits(vals):
    """The predicate is not vacuous: for each of these inputs it is false,
    and the sum in reversed or pairwise order differs from row order."""
    vals = np.asarray(vals, np.float64)
    ids = np.zeros(len(vals), np.int32)
    assert not _order_free(vals)
    sums = _orders(ids, vals, 1, 0)
    assert any(not np.array_equal(_bits(sums[o]), _bits(sums["row"]))
               for o in ("reversed", "pairwise"))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_nan_and_infinities_are_not_order_free(bad):
    vals = np.array([1.0, 2.0, bad, 4.0])
    assert not _order_free(vals)


def test_negative_zeros_sum_to_positive_zero():
    """All −0.0: order-free (nothing nonzero), and the row-order sum from
    +0.0 is +0.0, as in the reference; a tree over the leaves alone would
    give −0.0, which is why the card adds into a +0.0 output."""
    vals = np.full(7, -0.0)
    ids = np.zeros(7, np.int32)
    assert _order_free(vals)
    want = np.zeros(1)
    np.testing.assert_array_equal(_bits(_row_order(ids, vals, 1)), _bits(want))
    np.testing.assert_array_equal(_bits(_jax_segment_sum(ids, vals, 1)),
                                  _bits(want))
    plain = ops.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), 1)
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(want))
    assert math.copysign(1.0, -0.0 + -0.0) < 0   # the leaves' own sum


def test_empty_and_subnormal_columns():
    assert _order_free(np.zeros(0))
    assert _order_free(np.array([5e-324, 1e-323, -5e-324]))
    assert not _order_free(np.array([5e-324, 1.0]))


def test_the_query_sums_are_order_free():
    """Q-c's columns at SF1's value range: cents up to about 1.05e7 over
    6,001,215 rows and the counts; a tenth of a cent is not."""
    n = 6_001_215
    rng = np.random.default_rng(0)
    cents = rng.integers(90_000, 10_500_000, 4096).astype(np.float64)
    cents[0] = 10_500_000.0
    padded = np.concatenate([cents, np.zeros(n - len(cents))])
    assert _order_free(padded)
    assert _order_free(np.concatenate([np.ones(4096), np.zeros(n - 4096)]))
    assert not _order_free(np.concatenate([cents / 100.0,
                                           np.zeros(n - len(cents))]))
