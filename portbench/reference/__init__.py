"""Plain references of the benchmark's queries, one module per query, and
the comparison that decides a run's ``correct``.

Plain PyTorch over the benchmark's own tables.  Nothing here imports the
engine under test or takes anything it made.
"""
