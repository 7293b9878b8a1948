"""Training data: a synthetic corpus as relations, and the pipeline that
dedups, filters and orders it through the port's relational engine (the
join and sort on the card).  The counterpart of ``src/repro/data``."""
