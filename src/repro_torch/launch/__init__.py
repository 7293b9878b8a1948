"""Command-line entry points and their planning helpers (the counterpart
of ``src/repro/launch``): ``serve``, ``train``, ``dryrun``, with ``mesh``
(device meshes) and ``specs`` (meta-device trees)."""
