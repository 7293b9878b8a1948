"""Command-line entry points (the counterpart of ``src/repro/launch``; only
``serve`` is ported yet)."""
