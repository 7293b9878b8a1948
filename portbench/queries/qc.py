"""Q-c: each supplier's revenue, ``GROUP BY l_suppkey`` with
``sum(l_extendedprice)`` and ``count(l_quantity)``, over every line.

It groups as TPC-H Q15's revenue view (§2.4.15) does, but it is not Q15:
the view keeps the lines of one quarter's ``l_shipdate`` (about 2.3 M of
SF10's 60 M) and sums discounted prices, a column the deployment does not
hold.  Q-c keeps every line, about 26 times the view's rows, so that the
card's GROUP BY does the work and not the host's filter below it (the
engine filters below a GROUP BY on the host).  One group a supplier,
100,000 at SF10 (10,000 per unit of scale).  The answer is the groups in
ascending ``l_suppkey``, the order in which the engine's GROUP BY hands
them back.  Its plain reference is ``portbench/reference/qc.py``.
"""

#: the faults its answer must fail under (``portbench/faults/``)
FAULTS = ("answer_altered", "group_rows_halved")
#: its GROUP BY: the table, the key, each aggregate's column and function,
#: and the bytes of one value of each column it reads, as the card's
#: column cache holds it at SF10: codes of 4 bytes for both
#: (``portbench/metrics/groupby_roofline.py``)
GROUP = {"table": "lineitem", "key": "l_suppkey",
         "values": {"l_extendedprice": "sum", "l_quantity": "count"},
         "widths": {"l_suppkey": 4, "l_extendedprice": 4}}


def build(session, params):
    """The query through the engine's session API; it takes no
    parameters."""
    return session.table(GROUP["table"]).group_by(GROUP["key"],
                                                  GROUP["values"])
