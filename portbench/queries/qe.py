"""Q-e: TPC-H Q1's pricing summary, ``GROUP BY l_returnflag,
l_linestatus`` with ``sum(l_quantity)``, ``sum(l_extendedprice)`` and
``count(*)`` (as ``count(orderkey)``).

The two one-letter keys are the table's packed code
``l_returnflag_linestatus`` (flag × 2 + status): 4 groups.  Q1's filter
``l_shipdate <= DATE '1998-12-01' - 90 days``, which keeps 98.6% of the
lines, is left out: the engine runs a filter below a GROUP BY on the host,
so with it the query would time the host's filter, not the card's GROUP
BY; the host filter that every Q1 as users send it pays is left out with
it.  The sums of discounted prices and the averages need columns the
deployment does not hold.  The answer is the groups in ascending key, the
order of Q1's ``ORDER BY`` and the one in which the engine's GROUP BY
hands them back.  Its plain reference is ``portbench/reference/qe.py``.
"""

#: the faults its answer must fail under (``portbench/faults/``)
FAULTS = ("answer_altered", "group_rows_halved")
#: its GROUP BY: the table, the key, each aggregate's column and function,
#: and the bytes of one value of each column it reads, as the card's
#: column cache holds it at SF10: one-byte codes of the key and the
#: quantity, four-byte codes of the price
#: (``portbench/metrics/groupby_roofline.py``)
GROUP = {"table": "lineitem", "key": "l_returnflag_linestatus",
         "values": {"l_quantity": "sum", "l_extendedprice": "sum",
                    "orderkey": "count"},
         "widths": {"l_returnflag_linestatus": 1, "l_quantity": 1,
                    "l_extendedprice": 4}}


def build(session, params):
    """The query through the engine's session API; it takes no
    parameters."""
    return session.table(GROUP["table"]).group_by(GROUP["key"],
                                                  GROUP["values"])
