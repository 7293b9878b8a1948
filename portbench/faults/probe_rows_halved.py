"""``probe_rows_halved``: the fused fragment's join sees half of its probe
rows.

Planted in the three join cores of ``core/fused.py`` (``_join_dense``,
``_join_sorted``, ``_join_sorted_run``), whose ``n_probe`` is halved.
"""


def plant(monkeypatch):
    from repro_torch.core import fused

    for name in ("_join_dense", "_join_sorted", "_join_sorted_run"):
        core = getattr(fused, name)

        def halved(*args, _core=core, _name=name, **kw):
            args = list(args)
            i = 2 if _name == "_join_sorted_run" else 3   # n_probe
            args[i] = args[i] // 2
            return _core(*args, **kw)

        monkeypatch.setattr(fused, name, halved)
