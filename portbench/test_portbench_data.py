"""The generator and the plain references, on the CPU."""
import numpy as np
import pytest
import torch

from portbench import harness, tiny
from portbench.data import tpch
from portbench.reference import compare, qa, qb, qc, qe

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


def _hand_lineitem():
    return {"lineitem": {
        "orderkey": np.array([1, 1, 2, 3, 4, 4, 5]),
        "l_suppkey": np.array([3, 1, 3, 2, 1, 3, 2]),
        "l_quantity": np.array([1, 2, 3, 4, 5, 6, 7]),
        "l_extendedprice": np.array([100, 200, 300, 400, 500, 600,
                                     2**40 + 700]),
        # flag x 2 + status: R-F, A-F, N-O, R-F, A-F, N-F, R-F
        "l_returnflag_linestatus": np.array([4, 0, 3, 4, 0, 2, 4])}}


def test_group_references_against_hand_computed_answers():
    tables = _hand_lineitem()
    # supplier 1: lines 2 and 5; 2: lines 4 and 7; 3: lines 1, 3 and 6
    rows = qc.answer(tables, {}, "cpu")
    assert list(rows) == ["l_suppkey", "sum_l_extendedprice",
                          "count_l_quantity"]
    assert rows["l_suppkey"].tolist() == [1, 2, 3]
    assert rows["sum_l_extendedprice"].tolist() == [700, 2**40 + 1100, 1000]
    assert rows["count_l_quantity"].tolist() == [2, 2, 3]
    # A-F: lines 2 and 5; N-F: line 6; N-O: line 3; R-F: lines 1, 4, 7
    rows = qe.answer(tables, {}, "cpu")
    assert list(rows) == ["l_returnflag_linestatus", "sum_l_quantity",
                          "sum_l_extendedprice", "count_orderkey"]
    assert rows["l_returnflag_linestatus"].tolist() == [0, 2, 3, 4]
    assert rows["sum_l_quantity"].tolist() == [7, 6, 3, 12]
    assert rows["sum_l_extendedprice"].tolist() == [700, 600, 300,
                                                    2**40 + 1200]
    assert rows["count_orderkey"].tolist() == [2, 1, 1, 3]
    # the exact sum is lost in float32
    lower = qe.answer(tables, {}, "cpu", dtype=torch.float32)
    assert compare.rows_wrong(lower, rows) == 1


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


#: the TPC-H tables' sizes for the control's test: at :data:`tiny.TINY`'s
#: the joined prices stay within int32
CONTROL_SIZES = dict(CFG, orders=10000, lineitem=40000, scale=2.0)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_lower_precision_control_is_not_correct(cell, dtype):
    """The control: the reference in a lower precision, in the program's
    place, fails the comparison on each cell's own mix, at a tiny size: the
    configuration's ``"tiny"`` sizes, or :data:`CONTROL_SIZES`."""
    from portbench.control import control_numbers

    cell, entry = harness.cell_of(tiny.bench(), cell)
    cfg = harness.config_of(entry)
    cfg.update(cfg.get("tiny", CONTROL_SIZES))
    traffic = harness.traffic_of(cell["traffic"])
    for seed in (1, 2, 3):
        tables = harness.host_tables(harness.data_module(cfg["data"])
                                     .make_tables(cfg, seed, "cpu"))
        numbers = control_numbers(tables, traffic, "cpu", dtype)
        _, ok = compare.checks(numbers)
        assert not ok, (seed, numbers)
