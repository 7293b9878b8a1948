"""A star schema of another shape than TPC-H's, made from a seed: the
data generator of the CPU tests' fixture configuration
(``portbench/configs/star-fixture.json``), which no cell of
``BENCHMARK.json`` runs.

``stores`` (``store`` 1..n, unique; ``s_region`` drawn over the regions)
and ``sales`` (``store`` drawn over the stores; ``amount`` int64 cents
drawn over 1..10,000,000, so a region's sum passes 2**31 and is exact
only in 64 bits).  The same seed on the same kind of device gives the
same tables.
"""
from __future__ import annotations

from typing import Dict

import torch

#: the largest amount of a sale, in cents
MAX_AMOUNT = 10_000_000


def make_tables(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """``{"stores": ..., "sales": ...}``, each table a dict of column
    tensors on ``device``; ``cfg`` gives the rows of ``sales`` and
    ``stores`` and the number of ``regions``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    n_sales, n_stores = int(cfg["sales"]), int(cfg["stores"])
    store = torch.arange(1, n_stores + 1, dtype=torch.int64, device=device)
    region = torch.randint(0, int(cfg["regions"]), (n_stores,), generator=g,
                           device=device, dtype=torch.int64)
    s_store = torch.randint(1, n_stores + 1, (n_sales,), generator=g,
                            device=device, dtype=torch.int64)
    amount = torch.randint(1, MAX_AMOUNT + 1, (n_sales,), generator=g,
                           device=device, dtype=torch.int64)
    return {"stores": {"store": store, "s_region": region},
            "sales": {"store": s_store, "amount": amount}}
