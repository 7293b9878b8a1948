#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed 0]
[--profile]``.

Phases (any mismatch or exception ends the run with a non-zero exit code):

1. the card's name and power limit (``nvidia-smi``) and the build of the
   hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a, one
   process per source);
2. every kernel against its plain PyTorch version on the card, on the inputs
   the main path gives it, with timings (CUDA events, median of 20 launches)
   of the kernel, the plain version and, where one exists, the PyTorch
   library call that computes the same function, beside the least time the
   card could take for the bytes moved;
3. the main path, ``repro_torch.core.Session(policy="tensor",
   device="cuda")``, on a TPC-H SF1 deployment made with numpy from
   ``--seed``: (Q-a) lineitem ⋈ orders → filter → sort → sum, (Q-b) the same
   with a projected relation root, (Q-c) GROUP BY l_suppkey, (Q-d) orders
   filtered by date, ORDER BY o_custkey, o_orderdate (the per-operator
   device sort); each answer is held exactly against a numpy oracle written
   here, and the kernels' launch counters must rise during each query;
4. concurrent serving, ``repro_torch.core.QueryServer(device="cuda")`` over
   the same tables (64 MB shared budget, 1 MB work_mem): a closed loop of
   8 workers over Q-a..Q-d under ``policy="tensor"`` and ``"auto"``, then an
   open loop of two Poisson tenants for 2 s; no query may fail or be shed,
   every answer must equal the oracle, and the governor must never go over
   budget;
5. the four queries at a small scale on the card and on the CPU
   (``device="cpu"``, the plain versions), which must agree exactly.

The script imports nothing of JAX.  The line before the last is the card as
``nvidia-smi`` names it; the last line is one JSON object with the device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SF1_ORDERS = 1_500_000
SF1_LINEITEM = 6_001_215
WARM_RUNS = 5            # warm runs per query; the p50 is over these
D_1992_01_01 = 8035      # TPC-H STARTDATE, days since 1970-01-01
D_1998_08_02 = 10440     # ENDDATE - 151 days (last O_ORDERDATE)
D_1995_03_15 = 9204      # TPC-H Q3's date
H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
# the H100 SXM's published peak outside the tensor cores (float32,
# 67 TFLOP/s), taken as the rate of the scalar integer and float64
# operations of these kernels: an upper bound on their rate, so the
# operations bound is a lower bound
H100_SCALAR_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Data: a TPC-H deployment (v3 specification §4.2.3), made with numpy
# ---------------------------------------------------------------------------

def tpch(scale: float, seed: int):
    """``orders`` and ``lineitem`` with the TPC-H key, date and price
    domains.  Dates are int32 days since 1970-01-01; prices are int64
    cents, so every sum is exact."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_o = int(SF1_ORDERS * scale)
    n_l = int(SF1_LINEITEM * scale)
    i = np.arange(n_o, dtype=np.int64)
    # sparse keys: the first 8 of every 32 (§4.2.3, O_ORDERKEY)
    orderkey = (i // 8) * 32 + (i % 8) + 1
    custkey = rng.integers(1, int(150_000 * scale) + 1, n_o)
    custkey = custkey - (custkey % 3 == 0)   # never divisible by 3
    custkey[custkey < 1] = 1
    o_orderdate = rng.integers(D_1992_01_01, D_1998_08_02 + 1,
                               n_o).astype(np.int32)
    # 1..7 lines per order, nudged to the specification's row count
    lines = rng.integers(1, 8, n_o)
    diff = n_l - int(lines.sum())
    while diff:
        step = 1 if diff > 0 else -1
        pick = rng.integers(0, n_o, abs(diff))
        room = (lines[pick] < 7) if step > 0 else (lines[pick] > 1)
        pick = np.unique(pick[room])[:abs(diff)]
        lines[pick] += step
        diff = n_l - int(lines.sum())
    l_orderkey = np.repeat(orderkey, lines)
    l_suppkey = rng.integers(1, int(10_000 * scale) + 1, n_l).astype(np.int64)
    l_shipdate = (np.repeat(o_orderdate, lines)
                  + rng.integers(1, 122, n_l)).astype(np.int32)
    l_quantity = rng.integers(1, 51, n_l).astype(np.int64)
    partkey = rng.integers(1, int(200_000 * scale) + 1, n_l)
    retail_cents = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)
    l_extendedprice = (l_quantity * retail_cents).astype(np.int64)
    orders = {"orderkey": orderkey, "o_orderdate": o_orderdate,
              "o_custkey": custkey.astype(np.int64)}
    lineitem = {"orderkey": l_orderkey, "l_suppkey": l_suppkey,
                "l_shipdate": l_shipdate, "l_quantity": l_quantity,
                "l_extendedprice": l_extendedprice}
    return orders, lineitem


def oracle(orders, lineitem):
    """The four answers with numpy alone: searchsorted join, masks,
    lexsort, add.at."""
    import numpy as np

    ok = orders["orderkey"]
    pos = np.searchsorted(ok, lineitem["orderkey"])
    hit = ok[np.minimum(pos, len(ok) - 1)] == lineitem["orderkey"]
    od = orders["o_orderdate"][np.minimum(pos, len(ok) - 1)]
    m = hit & (od < D_1995_03_15) & (lineitem["l_shipdate"] > D_1995_03_15)
    rows = np.nonzero(m)[0]
    qa = int(lineitem["l_extendedprice"][rows].sum())
    order = np.lexsort((lineitem["orderkey"][rows], od[rows]))
    sel = rows[order]
    qb = {"orderkey": lineitem["orderkey"][sel],
          "b_o_orderdate": od[m][order],
          "l_extendedprice": lineitem["l_extendedprice"][sel]}
    uniq, inv = np.unique(lineitem["l_suppkey"], return_inverse=True)
    sums = np.zeros(len(uniq), np.float64)
    np.add.at(sums, inv, lineitem["l_extendedprice"].astype(np.float64))
    cnts = np.zeros(len(uniq), np.float64)
    np.add.at(cnts, inv, 1.0)
    qc = {"l_suppkey": uniq, "sum_l_extendedprice": sums,
          "count_l_quantity": cnts}
    # Q-d: rows in orderkey order, so a stable sort keeps ties in that order
    ock, ood = orders["o_custkey"], orders["o_orderdate"]
    rows = np.nonzero(ood < D_1995_03_15)[0]
    sel = rows[np.lexsort((ood[rows], ock[rows]))]
    qd = {"orderkey": orders["orderkey"][sel], "o_custkey": ock[sel],
          "o_orderdate": ood[sel]}
    return {"Q-a": qa, "Q-b": qb, "Q-c": qc, "Q-d": qd}


QUERIES = ("Q-a", "Q-b", "Q-c", "Q-d")


def queries(sess):
    from repro_torch.core import col

    def joined():
        return (sess.table("lineitem").join("orders", on="orderkey")
                .filter((col("b_o_orderdate") < D_1995_03_15)
                        & (col("l_shipdate") > D_1995_03_15))
                .sort("b_o_orderdate", "orderkey"))

    return {
        "Q-a": joined().aggregate("l_extendedprice", "sum"),
        "Q-b": joined().select("orderkey", "b_o_orderdate", "l_extendedprice"),
        "Q-c": sess.table("lineitem").group_by(
            "l_suppkey", {"l_extendedprice": "sum", "l_quantity": "count"}),
        "Q-d": (sess.table("orders")
                .filter(col("o_orderdate") < D_1995_03_15)
                .sort("o_custkey", "o_orderdate")
                .select("orderkey", "o_custkey", "o_orderdate")),
    }


def check_answer(name, res, want) -> None:
    import numpy as np

    if name == "Q-a":
        if res.scalar is None or res.scalar != float(want):
            fail(f"{name}: {res.scalar!r} != oracle {want}")
        return
    rel = res.relation
    if rel is None:
        fail(f"{name}: no relation result")
    if name == "Q-c":
        order = np.argsort(rel["l_suppkey"], kind="stable")
        got = {k: rel[k][order] for k in want}
    else:
        got = {k: rel[k] for k in want}
    for k, v in want.items():
        if got[k].shape != v.shape or not np.array_equal(got[k], v):
            fail(f"{name}: column {k} differs from the oracle "
                 f"({got[k].shape} vs {v.shape})")
        if not np.all(np.isfinite(got[k].astype(np.float64))):
            fail(f"{name}: column {k} has non-finite values")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int):
    """Least time for the work: bytes over the memory rate vs operations
    over the peak rate, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got, want) -> int:
    """Largest absolute difference over a kernel's integer outputs."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def kernel_phase(orders, lineitem, dev):
    """Each kernel on the main path's inputs: the probe and build codes the
    fused dense join hands the radix probe (planned by the engine's own
    ``_host_plan``), and the segment ids and values of the GROUP BY."""
    import numpy as np
    import torch

    from repro_torch.core import Relation
    from repro_torch.core.fused import _host_plan
    from repro_torch.core.tensor_engine import capacity_bucket
    from repro_torch.kernels.segment_join import kernel as K
    from repro_torch.kernels.segment_join import ops, ref

    build = Relation(dict(orders))
    probe = Relation(dict(lineitem))
    _, domain, kmin = _host_plan(build, probe, "orderkey")
    if domain is None:
        fail("the TPC-H build side did not plan the dense join core")

    def codes(keys, n):
        padded = np.zeros(capacity_bucket(n), np.int64)
        padded[:n] = keys
        k0 = torch.from_numpy(padded).to(dev) - kmin
        live = (torch.arange(len(padded), device=dev) < n) & (k0 >= 0) \
            & (k0 < domain)
        return torch.where(live, k0, domain).to(torch.int32)

    bk0c = codes(orders["orderkey"], len(build))
    pk0c = codes(lineitem["orderkey"], len(probe))
    dblk = ops.probe_block_size(domain)
    shift = dblk.bit_length() - 1
    nblocks = -(-(domain + 1) // dblk)
    ids_b = (bk0c >> shift).contiguous()
    ids_p = (pk0c >> shift).contiguous()
    rows = []

    # radix_rank at the probe side's shape (the build side is checked too)
    err = 0
    for ids in (ids_b, ids_p):
        got = K.radix_rank(ids, nblocks)
        want = ref.radix_rank_ref(ids, nblocks)
        err = max(err, int_err(got, want))
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail("radix_rank disagrees with its plain version")
    n = ids_p.numel()
    t_b, by = bound(n * 4 * 2 + nblocks * 4, n)
    rows.append({"name": "radix_rank", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:106",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: K.radix_rank(ids_p, nblocks)),
                 "plain_ms": time_ms(lambda: ref.radix_rank_ref(ids_p,
                                                                nblocks)),
                 "bound_ms": t_b, "bound_by": by, "library_ms": None,
                 "shape": f"n={n}, buckets={nblocks}"})

    # table build over the radix-ordered build side
    bdest, _ = ops.radix_partition(ids_b, nblocks)
    bk_ord, brow = ops._order(bk0c, bdest)
    dpad = nblocks * dblk
    got = K.join_table_build(bk_ord, brow, dpad)
    want = ref.join_table_build_ref(bk_ord, brow, dpad)
    err = int_err(got, want)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail("join_table_build disagrees with its plain version")
    cnt_t, inv_t = got
    code_l = bk_ord.long()
    live = (bk_ord >= 0) & (bk_ord < dpad)
    code_l = torch.where(live, code_l, 0)
    ones = live.to(torch.int32)
    rows1 = torch.where(live, brow + 1, 0)
    lib_cnt = torch.zeros(dpad, dtype=torch.int32, device=dev)
    lib_inv = torch.zeros(dpad, dtype=torch.int32, device=dev)

    def lib_build():
        lib_cnt.zero_().scatter_add_(0, code_l, ones)
        lib_inv.zero_().scatter_reduce_(0, code_l, rows1, reduce="amax")

    n = bk_ord.numel()
    t_b, by = bound(n * 8 + dpad * 8, 2 * n)
    rows.append({"name": "join_table_build", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:161",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: K.join_table_build(bk_ord, brow, dpad)),
                 "plain_ms": time_ms(lambda: ref.join_table_build_ref(
                     bk_ord, brow, dpad)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(lib_build),
                 "shape": f"n={n}, slots={dpad}"})

    # table probe over the radix-ordered probe side
    pdest, _ = ops.radix_partition(ids_p, nblocks)
    pk_ord, _ = ops._order(pk0c, pdest)
    got = K.join_table_probe(pk_ord, cnt_t, inv_t)
    want = ref.join_table_probe_ref(pk_ord, cnt_t, inv_t)
    err = int_err(got, want)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail("join_table_probe disagrees with its plain version")
    pk_l = pk_ord.long().clamp(0, dpad - 1)

    def lib_probe():
        torch.index_select(cnt_t, 0, pk_l)
        torch.index_select(inv_t, 0, pk_l)

    # the gathers read only the 32-byte sectors of the two tables that this
    # run's codes fall in, not the whole tables
    n = pk_ord.numel()
    hit = pk_ord[(pk_ord >= 0) & (pk_ord < dpad)]
    sectors = int(torch.unique(hit >> 3).numel())
    t_b, by = bound(n * 4 + sectors * 32 * 2 + n * 8, n)
    rows.append({"name": "join_table_probe", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:217",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: K.join_table_probe(pk_ord, cnt_t,
                                                          inv_t)),
                 "plain_ms": time_ms(lambda: ref.join_table_probe_ref(
                     pk_ord, cnt_t, inv_t)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(lib_probe),
                 "shape": f"n={n}, slots={dpad}, sectors read={sectors}"})

    # segment_sum: the GROUP BY's sorted segment ids and float64 values
    keys = torch.from_numpy(lineitem["l_suppkey"]).to(dev)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    newseg = torch.ones_like(sk, dtype=torch.bool)
    newseg[1:] = sk[1:] != sk[:-1]
    seg = (torch.cumsum(newseg.to(torch.int32), 0, dtype=torch.int32)
           - 1).contiguous()
    vals = torch.from_numpy(lineitem["l_extendedprice"]).to(dev).to(
        torch.float64)[order].contiguous()
    S = seg.numel()
    err = 0.0
    for v in (vals, torch.ones_like(vals)):
        got = K.segment_sum(seg, v, S)
        want = ref.segment_sum_ref(seg, v, S)
        if not torch.allclose(got, want, rtol=1e-12, atol=0.0):
            fail("segment_sum disagrees with its plain version (rtol 1e-12)")
        err = max(err, float((got - want).abs().max()))
    seg_l = seg.long()
    lib_out = torch.zeros(S, dtype=torch.float64, device=dev)
    t_b, by = bound(S * 12 + S * 8, S)
    rows.append({"name": "segment_sum", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:59",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: K.segment_sum(seg, vals, S)),
                 "plain_ms": time_ms(lambda: ref.segment_sum_ref(seg, vals,
                                                                 S)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(
                     lambda: lib_out.zero_().index_add_(0, seg_l, vals)),
                 "shape": f"n={S}, segments={S}"})
    return rows


def sort_kernel_phase(orders, dev):
    """The multi-key sort kernel on Q-d's inputs.  The row of the
    ``kernels`` line is one radix sort pass over the int64 key the main path
    sorts (``o_custkey`` of the 1995-03-15 filter's rows): its permutation
    is ``torch.sort(col, stable=True).indices``, the library call.  The
    whole ORDER BY (two key columns) and the 1,500,000-row sort with the
    filter as a validity mask are checked and timed beside it."""
    import torch

    from repro_torch.core.tensor_engine import _lex_perm
    from repro_torch.kernels.multikey_sort import kernel as K
    from repro_torch.kernels.multikey_sort import ops, ref

    ck = torch.from_numpy(orders["o_custkey"]).to(dev)
    od = torch.from_numpy(orders["o_orderdate"]).to(dev)
    valid = od < D_1995_03_15
    ck_f, od_f = ck[valid].contiguous(), od[valid].contiguous()

    def library(cols, mask):
        """The library composition: stable LSD ``torch.sort`` passes
        (``_lex_perm``, the fused fragment's sort), then the validity
        pass."""
        perm = _lex_perm(cols, cols[0].shape[0], dev)
        if mask is not None:
            perm = perm[torch.sort((~mask[perm]).to(torch.uint8),
                                   stable=True).indices]
        return perm

    err = 0
    checks = (((ck_f,), None), ((ck_f, od_f), None), ((ck, od), valid))
    for cols, mask in checks:
        got = ops.sort_perm(cols, mask)
        for want in (ref.sort_perm_ref(cols, mask), library(cols, mask)):
            if not torch.equal(got, want):
                fail(f"radix_sort_pass: the permutation over {len(cols)} "
                     f"key column(s) of {got.numel()} rows disagrees")
            err = max(err, int_err((got,), (want,)))
    for cols, mask, what in (((ck_f, od_f), None, "Q-d's ORDER BY"),
                             ((ck, od), valid, "the masked variant")):
        n = cols[0].numel()
        t_b, by = bound(sum(c.numel() * c.element_size() for c in cols)
                        + (n if mask is not None else 0) + n * 8,
                        n * (len(cols) + (mask is not None)))
        print(f"sort {what}: {len(cols)} key columns "
              f"({', '.join(str(c.dtype) for c in cols)}), {n} rows, "
              f"mask {mask is not None}: kernel "
              f"{time_ms(lambda: ops.sort_perm(cols, mask)):.4f} ms, plain "
              f"{time_ms(lambda: ref.sort_perm_ref(cols, mask), 5):.4f} ms, "
              f"torch.sort composition "
              f"{time_ms(lambda: library(cols, mask)):.4f} ms, bound "
              f"{t_b:.4f} ms by {by}", flush=True)
    n = ck_f.numel()
    t_b, by = bound(n * 8 + n * 8, n)
    return {"name": "radix_sort_pass", "route": "cuda",
            "source": "src/repro_torch/csrc/multikey_sort.cu",
            "replaces": "src/repro/kernels/multikey_sort/kernel.py:56",
            "max_abs_err": err,
            "ms": time_ms(lambda: K.radix_sort_pass(ck_f)),
            "plain_ms": time_ms(lambda: ref.radix_sort_pass_ref(ck_f), 5),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(lambda: torch.sort(ck_f, stable=True)),
            "shape": f"n={n}, int64 key (o_custkey of Q-d's rows)"}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(orders, lineitem, want):
    import torch

    from repro_torch import device as D
    from repro_torch.core import Session

    sess = Session(work_mem=1 << 20, policy="tensor", device="cuda")
    sess.register("orders", orders)
    sess.register("lineitem", lineitem)
    qs = queries(sess)
    expect = {
        "Q-a": ("radix_rank", "join_table_build", "join_table_probe"),
        "Q-b": ("radix_rank", "join_table_build", "join_table_probe"),
        "Q-c": ("segment_sum",),
        "Q-d": ("radix_sort_pass",),
    }
    torch.cuda.reset_peak_memory_stats()
    report = {}
    D.reset_launch_counts()
    for name, q in qs.items():
        before = D.launch_counts()
        t0 = time.perf_counter()
        res = q.collect()
        cold = time.perf_counter() - t0
        check_answer(name, res, want[name])
        warm, syncs, h2d = [], [], []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            res = q.collect()
            warm.append(time.perf_counter() - t0)
            check_answer(name, res, want[name])
            syncs.append(res.total_host_syncs)
            h2d.append(res.total_h2d_bytes)
        after = D.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        ops = [m.op for m in res.metrics]
        for k in expect[name]:
            if delta[k] <= 0:
                fail(f"{name}: kernel {k} was not launched ({delta})")
        if name in ("Q-a", "Q-b"):
            if ops != ["fused_pipeline"]:
                fail(f"{name} did not run as one fused fragment: {ops}")
            if set(syncs) != {1} or set(h2d) != {0}:
                fail(f"{name}: warm host_syncs {syncs}, h2d bytes {h2d}")
        if name == "Q-d" and "sort" not in ops:
            fail(f"Q-d did not run the per-operator device sort: {ops}")
        report[name] = {"cold_s": cold,
                        "warm_p50_s": statistics.median(warm),
                        "warm_runs": WARM_RUNS, "ops": ops,
                        "warm_host_syncs": syncs[-1],
                        "warm_h2d_bytes": h2d[-1], "launches": delta}
    launches = D.launch_counts()
    report["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return report, launches


# ---------------------------------------------------------------------------
# Phase 4: concurrent serving
# ---------------------------------------------------------------------------

SERVE_TOTAL_MEM = 64 << 20
SERVE_WORK_MEM = 1 << 20


def check_served(label, rep, names, want) -> None:
    """No failed or shed query, no over-budget event, and every served
    answer equal to the oracle (the server turns exceptions into
    FailedQuery records, so a kernel fault would otherwise pass)."""
    if rep.failed:
        f = rep.failed[0]
        fail(f"{label}: {len(rep.failed)} queries failed, first "
             f"{names[f.workload_idx]}: {f.error}: {f.message}")
    if rep.shed:
        fail(f"{label}: {len(rep.shed)} queries were shed")
    if rep.governor.over_budget_events != 0:
        fail(f"{label}: {rep.governor.over_budget_events} over-budget events")
    for q in rep.queries:
        check_answer(names[q.workload_idx], q, want[names[q.workload_idx]])


def serving_closed(orders, lineitem, want, policy):
    import collections

    from repro_torch import device as D
    from repro_torch.core import QueryServer

    server = QueryServer({"orders": orders, "lineitem": lineitem},
                         total_mem=SERVE_TOTAL_MEM, work_mem=SERVE_WORK_MEM,
                         policy=policy, device="cuda")
    qs = queries(server.session)
    names = list(qs)
    D.reset_launch_counts()
    rep = server.serve([qs[k] for k in names], concurrency=8,
                       queries_per_worker=4, warmup=1)
    launches = D.launch_counts()
    check_served(f"closed loop ({policy})", rep, names, want)
    if policy == "tensor":
        idle = [k for k, v in launches.items() if v <= 0]
        if idle:
            fail(f"closed loop (tensor): kernels {idle} were not launched")
    paths = collections.Counter(f"{names[q.workload_idx]}:{q.paths}"
                                for q in rep.queries)
    return server, {"policy": policy, "counts": rep.counts,
                    "p50_s": rep.latency.p50, "p99_s": rep.latency.p99,
                    "p99_over_p50": rep.p99_over_p50, "qps": rep.qps,
                    "wall_s": rep.wall_s, "paths": dict(sorted(paths.items())),
                    "over_budget_events": rep.governor.over_budget_events,
                    "launches": launches}


def serving_open(server, policy, want, seed: int):
    from repro_torch import device as D
    from repro_torch.core import ArrivalProcess, TenantClass

    qs = queries(server.session)
    names = list(qs)
    wl = [qs[k] for k in names]
    D.reset_launch_counts()
    rep = server.serve_open(
        workloads={"prem": wl, "be": wl},
        arrivals={"prem": ArrivalProcess(rate_qps=10, seed=seed + 1),
                  "be": ArrivalProcess(rate_qps=10, seed=seed + 2)},
        duration_s=2.0, workers=4, keep_relations=True,
        tenants=[TenantClass("prem", deadline_s=5.0, priority=2,
                             sheddable=False),
                 TenantClass("be", deadline_s=5.0)])
    launches = D.launch_counts()
    check_served("open loop", rep, names, want)
    c = rep.counts
    if c["submitted"] != c["served"]:
        fail(f"open loop: submitted {c['submitted']} != served {c['served']}")
    if server.governor.held_bytes != 0:
        fail(f"open loop: {server.governor.held_bytes} bytes still held")
    tenants = {}
    for t in ("prem", "be"):
        lat = rep.tenant_latency(t)
        tenants[t] = {"counts": rep.tenant_counts(t),
                      "p50_s": lat.p50 if lat else None,
                      "p99_s": lat.p99 if lat else None,
                      "slo_attainment": rep.slo_attainment(t)}
    return {"policy": policy, "counts": c,
            "tenants": tenants, "wall_s": rep.wall_s,
            "held_bytes": server.governor.held_bytes, "launches": launches}


def profile_queries(orders, lineitem) -> None:
    """Where a warm query's time goes: torch.profiler over one warm run of
    each query, the top kernels by device time, and the device's busy
    share of the query's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Session

    sess = Session(work_mem=1 << 20, policy="tensor", device="cuda")
    sess.register("orders", orders)
    sess.register("lineitem", lineitem)
    for name, q in queries(sess).items():
        q.collect()
        q.collect()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            q.collect()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host ops: their kernels are counted below them
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"profile {name}: wall {wall_us:.0f} us, device busy "
              f"{busy:.0f} us ({100 * busy / wall_us:.1f}%), idle "
              f"{100 - 100 * busy / wall_us:.1f}%", flush=True)
        for dev_us, count, key in rows[:12]:
            print(f"  {dev_us:10.1f} us  x{count:<3d} {key[:90]}",
                  flush=True)


def small_agreement(seed: int) -> None:
    """The card and the CPU (plain versions) must give equal answers."""
    import numpy as np

    from repro_torch.core import Session

    orders, lineitem = tpch(0.01, seed + 1)
    answers = {}
    for dev in ("cuda", "cpu"):
        sess = Session(work_mem=1 << 20, policy="tensor", device=dev)
        sess.register("orders", orders)
        sess.register("lineitem", lineitem)
        answers[dev] = {k: q.collect() for k, q in queries(sess).items()}
    for k in answers["cuda"]:
        a, b = answers["cuda"][k], answers["cpu"][k]
        if (a.scalar != b.scalar or (a.relation is None) != (b.relation is None)
                or (a.relation is not None
                    and not a.relation.equals(b.relation))):
            fail(f"{k}: the card and the CPU disagree at small scale")
    if not np.isfinite(answers["cuda"]["Q-a"].scalar):
        fail("Q-a is not finite at small scale")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each query with "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "device.py").is_file():
        fail("run from the root of a checkout: src/repro_torch is missing")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(root / "src"))
    from repro_torch import device as D

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {kind}", flush=True)
    t0 = time.perf_counter()
    for lib in ("segment_join", "multikey_sort"):
        D.kernel_library(lib)
    print(f"kernel build (segment_join.cu, multikey_sort.cu): "
          f"{time.perf_counter() - t0:.2f} s (nvcc {D.build_seconds():.2f} s)",
          flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    orders, lineitem = tpch(1.0, args.seed)
    want = oracle(orders, lineitem)
    print(f"data: {len(orders['orderkey'])} orders, "
          f"{len(lineitem['orderkey'])} lineitems, Q-b rows "
          f"{len(want['Q-b']['orderkey'])}, Q-c groups "
          f"{len(want['Q-c']['l_suppkey'])}, Q-d rows "
          f"{len(want['Q-d']['orderkey'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # phase 2: kernels against their plain versions
    rows = kernel_phase(orders, lineitem, dev)
    rows.append(sort_kernel_phase(orders, dev))
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}) at {r['shape']}",
              flush=True)

    # phase 3: the main path, counters from 0
    report, launches = main_path(orders, lineitem, want)
    for name in QUERIES:
        r = report[name]
        print(f"{name}: cold {r['cold_s']:.4f} s, warm p50 "
              f"{r['warm_p50_s']:.4f} s over {r['warm_runs']}, ops "
              f"{r['ops']}, warm host_syncs {r['warm_host_syncs']}, warm "
              f"h2d {r['warm_h2d_bytes']} B, launches {r['launches']}",
              flush=True)
    print(f"peak device memory allocated: {report['peak_allocated_bytes']} B",
          flush=True)

    if args.profile:
        profile_queries(orders, lineitem)

    # phase 4: concurrent serving, counters from 0 before each loop
    serving = {}
    for policy in ("tensor", "auto"):
        t0 = time.perf_counter()
        server, r = serving_closed(orders, lineitem, want, policy)
        serving[f"closed_{policy}"] = r
        print(f"closed loop ({policy}, 8 workers x 4): {r['counts']}, p50 "
              f"{r['p50_s']:.4f} s, p99 {r['p99_s']:.4f} s, p99/p50 "
              f"{r['p99_over_p50']:.3f}, {r['qps']:.1f} q/s, paths "
              f"{r['paths']}, launches {r['launches']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    r = serving_open(server, "auto", want, args.seed)
    serving["open_auto"] = r
    print(f"open loop (auto, 2 s, 4 workers): {r['counts']}, tenants "
          f"{r['tenants']}, held bytes {r['held_bytes']}, launches "
          f"{r['launches']} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # phase 5: card vs CPU at small scale
    small_agreement(args.seed)
    print("small-scale card/CPU agreement: ok", flush=True)

    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"queries": {k: report[k] for k in QUERIES},
                      "peak_allocated_bytes": report["peak_allocated_bytes"],
                      "serving": serving}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
