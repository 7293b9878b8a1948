"""Q-a: TPC-H Q3's join core with a scalar root.

``lineitem ⋈ orders`` on ``orderkey``, ``o_orderdate < DATE`` and
``l_shipdate > DATE``, ordered by ``o_orderdate, orderkey``, and
``sum(l_extendedprice)`` over what is left.  The predicate on
``c_mktsegment`` goes with the ``customer`` table, which the deployment
does not hold.  Its plain reference is ``portbench/reference/qa.py``.
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
            .aggregate("l_extendedprice", "sum"))
