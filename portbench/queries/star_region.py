"""The fixture's query: each region's sales, ``sales ⋈ stores`` on
``store``, ``GROUP BY s_region`` with ``sum(amount)`` and
``count(store)``.

A join under a GROUP BY matches no fused fragment, so the generic walk
runs it: the per-operator join on the card, then the GROUP BY.  The
answer is the regions in ascending order.  Its plain reference is
``portbench/reference/star_region.py``.
"""

#: the faults its answer must fail under (``portbench/faults/``)
FAULTS = ("answer_altered", "operator_probe_rows_halved",
          "group_rows_halved")


def build(session, params):
    """The query through the engine's session API; it takes no
    parameters."""
    return (session.table("sales").join("stores", on="store")
            .group_by("b_s_region", {"amount": "sum", "store": "count"}))
