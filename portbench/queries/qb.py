"""Q-b: TPC-H Q3's join core with a relation root.

As Q-a (``portbench/queries/qa.py``), but the answer is the rows
themselves, ``(orderkey, o_orderdate, l_extendedprice)`` in the order
``o_orderdate, orderkey``: about 1.49 million rows at SF10.  Rows with
equal keys (lines of one order) keep the order of ``lineitem``.  Its plain
reference is ``portbench/reference/qb.py``.
"""

#: the faults its answer must fail under (``portbench/faults/``)
FAULTS = ("answer_altered", "probe_rows_halved")
#: the tables of its one join: (build, probe)
JOIN = ("orders", "lineitem")


def build(session, params):
    """The query through the engine's session API; ``params["date"]`` is
    DATE in days since 1970-01-01."""
    from repro_torch.core import col

    date = int(params["date"])
    return (session.table("lineitem").join("orders", on="orderkey")
            .filter((col("b_o_orderdate") < date)
                    & (col("l_shipdate") > date))
            .sort("b_o_orderdate", "orderkey")
            .select("orderkey", "b_o_orderdate", "l_extendedprice"))
