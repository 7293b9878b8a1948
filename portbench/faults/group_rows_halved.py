"""``group_rows_halved``: the tensor path's GROUP BY
(``core/aggregate.py``'s ``group_aggregate_device``) sees the first half
of its input's rows only."""


def plant(monkeypatch):
    import torch

    from repro_torch.core import aggregate

    group = aggregate.group_aggregate_device

    def halved(rel, key, values):
        half = torch.arange(rel.num_physical_rows // 2, device=rel.device)
        return group(rel.take_lazy(half), key, values)

    monkeypatch.setattr(aggregate, "group_aggregate_device", halved)
