"""TPC-H ``orders`` and ``lineitem`` made from a seed, with torch, in bulk.

The data generator of every configuration whose ``data`` is ``"tpch"``.

A copy of ``chip_smoke.py::tpch`` (numpy) moved to torch so that the
tables of SF10 are drawn on the card in a few large calls: the key, date
and price domains of the TPC-H v3 specification, §4.2.3, with prices as
int64 cents (every sum exact) and dates as int32 days since 1970-01-01.
The row counts come from the configuration (SF10: 15,000,000 orders and
the specification's 59,986,052 lines), the domains of the foreign keys
from its ``scale``.

The same seed on the same kind of device gives the same tables: every
draw comes from one ``torch.Generator`` seeded once, in a fixed order of
calls of fixed sizes.  The CPU and the card draw different streams.
"""
from __future__ import annotations

from typing import Dict

import torch

D_1992_01_01 = 8035      # STARTDATE
D_1998_08_02 = 10440     # ENDDATE - 151 days: the last O_ORDERDATE
D_1995_06_17 = 9298      # CURRENTDATE

#: columns of each table, in the order they are drawn
ORDERS = ("orderkey", "o_orderdate", "o_custkey")
LINEITEM = ("orderkey", "l_suppkey", "l_shipdate", "l_quantity",
            "l_extendedprice", "l_returnflag_linestatus")


def generator(seed: int, device: torch.device) -> torch.Generator:
    """One generator on ``device`` for the whole deployment; any whole
    number is a seed (folded into the 64 bits the generator keeps)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _randint(g, lo: int, hi: int, n: int, device, dtype=torch.int64):
    """``n`` integers uniform over ``[lo, hi]``, both ends included."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=dtype)


def _nudge(lines: torch.Tensor, total: int, g) -> torch.Tensor:
    """Lines per order moved by one on distinct orders, drawn from ``g``,
    so that they add up to ``total`` and stay within 1..7."""
    diff = total - int(lines.sum())
    if diff == 0:
        return lines
    room = (lines < 7) if diff > 0 else (lines > 1)
    cand = torch.nonzero(room).squeeze(1)
    if cand.numel() < abs(diff):
        raise ValueError(f"{lines.numel()} orders cannot hold {total} lines")
    pick = cand[torch.randperm(cand.numel(), generator=g,
                               device=lines.device)[:abs(diff)]]
    lines[pick] += 1 if diff > 0 else -1
    return lines


def make_tables(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """``{"orders": ..., "lineitem": ...}``, each table a dict of column
    tensors on ``device``.

    ``cfg`` gives ``orders`` and ``lineitem`` (row counts) and ``scale``
    (the domains: 150,000 customers, 10,000 suppliers and 200,000 parts
    per unit of scale)."""
    device = torch.device(device)
    g = generator(seed, device)
    n_o, n_l, scale = int(cfg["orders"]), int(cfg["lineitem"]), cfg["scale"]
    i = torch.arange(n_o, dtype=torch.int64, device=device)
    # sparse keys: the first 8 of every 32 (O_ORDERKEY)
    orderkey = (i // 8) * 32 + (i % 8) + 1
    del i
    custkey = _randint(g, 1, int(150_000 * scale), n_o, device)
    custkey = torch.clamp(custkey - (custkey % 3 == 0).long(), min=1)
    o_orderdate = _randint(g, D_1992_01_01, D_1998_08_02, n_o, device,
                           torch.int32)
    lines = _nudge(_randint(g, 1, 7, n_o, device), n_l, g)
    l_orderkey = torch.repeat_interleave(orderkey, lines, output_size=n_l)
    l_suppkey = _randint(g, 1, int(10_000 * scale), n_l, device)
    l_shipdate = (torch.repeat_interleave(o_orderdate, lines, output_size=n_l)
                  + _randint(g, 1, 121, n_l, device, torch.int32))
    del lines
    l_quantity = _randint(g, 1, 50, n_l, device)
    partkey = _randint(g, 1, int(200_000 * scale), n_l, device)
    retail_cents = (90_000 + (partkey // 10) % 20_001
                    + 100 * (partkey % 1000))
    del partkey
    l_extendedprice = l_quantity * retail_cents
    del retail_cents
    # received 1..30 days after shipping; L_RETURNFLAG R or A at random
    # when received by CURRENTDATE, else N; L_LINESTATUS O when shipped
    # after CURRENTDATE, else F.  Q1's two CHAR(1) keys as one code:
    # flag (A, N, R) * 2 + status (F, O)
    received = l_shipdate + _randint(g, 1, 30, n_l, device, torch.int32)
    coin = _randint(g, 0, 1, n_l, device)
    flag = torch.where(received <= D_1995_06_17, 2 * coin, 1)
    del received, coin
    l_returnflag_linestatus = 2 * flag + (l_shipdate > D_1995_06_17).long()
    del flag
    orders = {"orderkey": orderkey, "o_orderdate": o_orderdate,
              "o_custkey": custkey}
    lineitem = {"orderkey": l_orderkey, "l_suppkey": l_suppkey,
                "l_shipdate": l_shipdate, "l_quantity": l_quantity,
                "l_extendedprice": l_extendedprice,
                "l_returnflag_linestatus": l_returnflag_linestatus}
    return {"orders": orders, "lineitem": lineitem}
