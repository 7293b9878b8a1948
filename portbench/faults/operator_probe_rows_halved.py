"""``operator_probe_rows_halved``: the tensor path's per-operator join
(``core/tensor_engine.py``'s ``tensor_join_device``, which the generic
walk runs where no fused fragment matches) sees the first half of its
probe side's rows only."""


def plant(monkeypatch):
    import torch

    from repro_torch.core import executor, tensor_engine

    join = tensor_engine.tensor_join_device

    def halved(build, probe, key, *args, **kw):
        half = torch.arange(probe.num_physical_rows // 2,
                            device=probe.device)
        return join(build, probe.take_lazy(half), key, *args, **kw)

    monkeypatch.setattr(tensor_engine, "tensor_join_device", halved)
    monkeypatch.setattr(executor, "tensor_join_device", halved)
