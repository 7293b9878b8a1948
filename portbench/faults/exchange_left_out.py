"""``exchange_left_out``: the sharded fragment's partials never meet; a
summed scalar is the first card's partial alone (``core/fused.py``'s
``_COMBINE``).  Only a cell that spans cards can have this fault."""


def plant(monkeypatch):
    from repro_torch.core import fused

    combine = dict(fused._COMBINE)
    combine["sum"] = lambda partials: partials[0]
    monkeypatch.setattr(fused, "_COMBINE", combine)
