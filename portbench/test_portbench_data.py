"""The generator and the plain references, on the CPU."""
import numpy as np
import pytest
import torch

from portbench.data import tpch
from portbench.reference import compare, qa, qb

CFG = {"orders": 4000, "lineitem": 16000, "scale": 0.002}


def test_generator_is_deterministic_from_the_seed():
    seed = 2**31 + 3          # seeds go past 32 signed bits
    a = tpch.make_tables(CFG, seed, "cpu")
    b = tpch.make_tables(CFG, seed, "cpu")
    c = tpch.make_tables(CFG, seed + 1, "cpu")
    assert list(a) == list(b) == ["orders", "lineitem"]
    for ta, tb, tc in zip(a.values(), b.values(), c.values()):
        assert list(ta) == list(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k
        assert any(not torch.equal(ta[k], tc[k]) for k in ta if k != "orderkey")


def test_generator_keeps_the_specification_domains():
    tables = tpch.make_tables(CFG, 12, "cpu")
    orders, lineitem = tables["orders"], tables["lineitem"]
    assert tuple(orders) == tpch.ORDERS and tuple(lineitem) == tpch.LINEITEM
    assert all(len(v) == CFG["orders"] for v in orders.values())
    assert all(len(v) == CFG["lineitem"] for v in lineitem.values())
    ok = orders["orderkey"]
    assert bool((ok[1:] > ok[:-1]).all()) and bool(((ok - 1) % 32 < 8).all())
    lines = torch.bincount(torch.searchsorted(ok, lineitem["orderkey"]),
                           minlength=len(ok))
    assert int(lines.min()) >= 1 and int(lines.max()) <= 7
    od = orders["o_orderdate"][torch.searchsorted(ok, lineitem["orderkey"])]
    gap = lineitem["l_shipdate"] - od
    assert int(gap.min()) >= 1 and int(gap.max()) <= 121
    assert orders["o_orderdate"].dtype == torch.int32
    assert int(orders["o_orderdate"].min()) >= tpch.D_1992_01_01
    assert int(orders["o_orderdate"].max()) <= tpch.D_1998_08_02
    assert bool((orders["o_custkey"] % 3 != 0).all())
    assert int(lineitem["l_suppkey"].max()) <= 20
    q = lineitem["l_quantity"]
    assert int(q.min()) >= 1 and int(q.max()) <= 50
    assert bool((lineitem["l_extendedprice"] % q == 0).all())
    assert set(lineitem["l_returnflag_linestatus"].tolist()) <= {0, 1, 2, 3, 4, 5}


def _hand_tables():
    orders = {"orderkey": np.array([1, 2, 3, 4]),
              "o_orderdate": np.array([9000, 9300, 9100, 9203], np.int32)}
    lineitem = {
        "orderkey": np.array([1, 1, 2, 3, 4, 4, 5]),
        "l_shipdate": np.array([9300, 9301, 9400, 9205, 9204, 9250, 9300],
                               np.int32),
        "l_extendedprice": np.array([100, 200, 300, 400, 500, 600, 700])}
    return {"orders": orders, "lineitem": lineitem}


def test_references_against_hand_computed_answers():
    tables = _hand_tables()
    # kept: order 1's two lines (9000), order 3's (9100), order 4's second
    # (9203, shipped after DATE); order 2 is too late, order 5 is absent
    assert qa.answer(tables, {"date": 9204}, "cpu") == 1300
    rows = qb.answer(tables, {"date": 9204}, "cpu")
    assert rows["orderkey"].tolist() == [1, 1, 3, 4]
    assert rows["b_o_orderdate"].tolist() == [9000, 9000, 9100, 9203]
    # the two lines of order 1 tie on both keys and keep lineitem's order
    assert rows["l_extendedprice"].tolist() == [100, 200, 400, 600]


def test_comparison_counts_every_difference():
    want = {"a": np.array([1, 2, 3]), "b": np.array([4, 5, 6])}
    assert compare.rows_wrong(dict(want), want) == 0
    assert compare.rows_wrong({"a": np.array([1, 9, 3]),
                               "b": np.array([4, 5, 7])}, want) == 2
    assert compare.rows_wrong({"a": np.array([1, 2]),
                               "b": np.array([4, 5])}, want) == 1
    assert compare.rows_wrong({"a": np.array([1, 2, 3])}, want) == 3
    assert compare.scalar_err(1300.0, 1300) == 0
    assert compare.scalar_err(None, 1300) == float("inf")
    checks, ok = compare.checks([("qa_abs_err", "abs_err", 1.0),
                                 ("failed", "failed", 0)])
    assert not ok and checks["qa_abs_err"] == {"value": 1.0, "limit": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lower_precision_control_is_not_correct(dtype):
    """The control: the reference in a lower precision, in the program's
    place, fails the comparison on the cell's own mix, at a tiny size."""
    from portbench import harness
    from portbench.control import control_numbers

    traffic = harness.traffic_of("q3-8streams")
    for seed in (1, 2, 3):
        tables = harness.host_tables(tpch.make_tables(
            dict(CFG, orders=10000, lineitem=40000, scale=2.0), seed, "cpu"))
        numbers = control_numbers(tables, traffic, "cpu", dtype)
        _, ok = compare.checks(numbers)
        assert not ok, (seed, numbers)
