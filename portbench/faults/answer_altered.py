"""``answer_altered``: every answer the engine hands back is off by one.

Planted where each answer reaches the host: the fused fragment's fetch
(``core/fused.py``'s ``_fetch``: its scalar and every numeric column of
its rows), the fetch of a device relation (``DeviceRelation.to_host``,
the generic walk's relation roots: every numeric column) and the
executor's fetch of a device scalar (``core/executor.py``'s ``to_host``).
"""
import numpy as np


def _off_by_one(a):
    return a + 1 if np.issubdtype(a.dtype, np.number) else a


def plant(monkeypatch):
    from repro_torch.core import executor, fused
    from repro_torch.core.device_relation import DeviceRelation
    from repro_torch.core.relation import Relation

    fetch = fused._fetch
    to_host = DeviceRelation.to_host
    fetch_scalar = executor.to_host

    def altered_fetch(out):
        got = fetch(out)
        if "scalar" in got:
            got["scalar"] = got["scalar"] + 1
        cols = got.get("cols", {})
        for k in cols:
            cols[k] = _off_by_one(cols[k])
        return got

    def altered_to_host(self):
        rel = to_host(self)
        return Relation({k: _off_by_one(rel[k]) for k in rel.names})

    def altered_scalar(tensors):
        value, *rest = fetch_scalar(tensors)
        return [value + 1, *rest]

    monkeypatch.setattr(fused, "_fetch", altered_fetch)
    monkeypatch.setattr(DeviceRelation, "to_host", altered_to_host)
    monkeypatch.setattr(executor, "to_host", altered_scalar)
