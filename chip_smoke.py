#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed 0]
[--profile]``.  ``--only PHASE`` runs one phase alone and ``--tree DIR``
drives another checkout's package with it: to compare two commits, run
each in its own process, in turns on one card (parent, change, change,
parent).  The phases: ``moe-dispatch`` (the layer body's dispatch call),
``moe-layer`` (the layer body with an identity FFN: dispatch, combine and
the routing's slots), each at the decode and prefill shapes;
``join-build`` (the table build at Q-a's build shape, then Q-a and Q-b
warm and traced); ``join-probe`` (``radix_hash_probe`` at Q-a's shape with
the probe codes in order and shuffled, then Q-a and Q-b); ``segment-sum``
(the segment sum's cases at Q-c's shape, then Q-c and Q-e); ``sharded``
(phase 5b, after the single-device Q-a; with ``--profile``, traces of
both); ``pressure`` (phase 4b); ``lm`` (phase 6); ``train`` (phase 2's
training rows, then phase 8); ``dryrun`` (phase 9); ``cards`` (phase 10,
on a machine with four cards).

Phases (any mismatch or exception ends the run with a non-zero exit code):

1. the card's name and power limit (``nvidia-smi``) and the build of the
   hand-written kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a, one
   process per source);
2. every kernel against its plain PyTorch version on the card, on the inputs
   the main path gives it, with timings (CUDA events, median of 20 launches)
   of the kernel, the plain version and, where one exists, the PyTorch
   library call that computes the same function, beside the least time the
   card could take for the bytes moved; ``radix_rank`` at the join's build
   and probe sides, ``radix_sort_pass`` with the digit passes that ran and
   on columns that vary in chosen digits only, ``join_table_build`` as the
   main path hands it over and without its padding rows, in random order
   and with all or half the rows at one code, ``join_table_probe`` on the
   probe codes in row order and the probe side of the join (the parent's
   radix-ordered composition against one row-order probe, codes in order
   and shuffled), ``segment_sum`` bit for bit against its plain version on
   the CPU, with the route the card took, on non-integer values (sorted,
   with one segment holding half the rows, unsorted), on ones (the counts)
   and on Q-c's integer cents (sorted, skewed, unsorted), flash attention
   against SDPA at Phi-3.5-MoE's heads (bf16 and float32) and
   DeepSeek-V2-Lite's MLA widths (bf16, D 192, Dv 128), the combine over
   all routing slots of the layer (one launch, against the plain version
   and the single-slot kernels added in turn) at Phi-3.5-MoE's top-2 of 16
   and DeepSeek-V2-Lite's top-6 of 64, and the MoE kernels with device
   time from the profiler's kernel times at both models' prefill shapes
   and Phi-3.5-MoE's decode shape, host time a call at the decode shape,
   and the library call's;
3. the main path, ``repro_torch.core.Session(policy="tensor",
   device="cuda")``, on a TPC-H SF1 deployment made with numpy from
   ``--seed``: (Q-a) lineitem ⋈ orders → filter → sort → sum, (Q-b) the same
   with a projected relation root, (Q-c) GROUP BY l_suppkey, (Q-d) orders
   filtered by date, ORDER BY o_custkey, o_orderdate (the per-operator
   device sort), (Q-e) TPC-H Q1's GROUP BY l_returnflag, l_linestatus with
   its integer aggregates (sum of l_quantity and of l_extendedprice,
   count) over all of lineitem: four groups, the largest near half the
   rows; each answer is held exactly against a numpy oracle written
   here, and the kernels' launch counters must rise during each query;
4. concurrent serving, ``repro_torch.core.QueryServer(device="cuda")`` over
   the same tables (64 MB shared budget, 1 MB work_mem): a closed loop of
   8 workers over Q-a..Q-d under ``policy="tensor"`` and ``"auto"``, then an
   open loop of two Poisson tenants for 2 s; no query may fail or be shed,
   every answer must equal the oracle, and the governor must never go over
   budget;
4b. the memory-pressure path, each check failing the run: (1) the paper's
   headline, ``benchmarks/common.py::sort_table(1_000_000, 4)``'s columns
   made here with numpy from ``--seed``, sorted by ``sort_linear`` at 1 MB
   of work_mem (an external merge sort spilling to disk) and by
   ``tensor_sort`` on the card, 1 warm-up and 5 runs each (p50, max,
   spilled MB and 8 KB blocks), rows equal to a numpy lexsort,
   ``radix_sort_pass`` launched; (2) Q-a's join core at SF1 (lineitem ⋈
   orders → sum(l_extendedprice), no filter) at 1 MB in four ways:
   ``linear`` to flat disk, ``linear`` through ``TierConfig()``'s tiers, and
   a stale ``auto`` session (fig14's constants: linear priced 50x too
   cheap) with guards off and on; each answer the oracle's, every spilled
   byte freed, the tier books balanced; (3) the guards' switches onto the
   card: the star join of ``tests/test_adaptive_guards.py`` (120,000 rows,
   256 KB) and its sort (200,000 rows, 128 KB) under stale ``auto``, each
   with exactly one operator switched from linear to tensor, the answer of
   a linear run at 64 MB, and the takeover's kernels launched
   (``radix_rank``, ``join_table_build``, ``join_table_probe``;
   ``radix_sort_pass``); (4) that test file's chaos hammer on the card (8
   workers x 4, tiers, injected spill, grant and slow-device faults, eager
   hysteresis): every query served or failed, every answer the oracle's,
   no over-budget event, balanced books, faults injected, switches
   printed; (5) SF1 Q-a through a session whose injector fails every
   device lease: the oracle's answer on the linear path after
   ``RetryPolicy.device_fallback_after`` failures, every operator's
   reason ``device-fallback``, a reason no other operator of phases 3 to
   4b may carry (that fallback is for injected faults: a real kernel or
   CUDA error propagates);
5. the four queries at a small scale on the card and on the CPU
   (``device="cpu"``, the plain versions), which must agree exactly;
5b. the sharded fused fragment over eight logical lanes, its partitions
   placed on the cards present (``device="cuda"``; the default run has
   one, and the lines name the cards used), on the SF1 tables still
   built: (a) fig15's fragment
   (``benchmarks/figures.py``: 1,000,000 unique sparse build keys, probe
   keys drawn from them, ``w < 500``, ``sum(b_v)``) through ``run_fused``
   at 1, 2, 4 and 8 shards, 2 cold and 7 warm runs each, every scalar equal
   to the numpy oracle, warm runs with 1 host sync, 0 H2D bytes when
   sharded, and all 8 lanes dispatched; (b) Q-a through
   ``Session(policy="auto", max_shards=8)``, whose selector must pick the
   sharded program (a forced ``tensor`` policy decides one device, as in
   the reference), held to phase 3's oracle with 1 warm sync and 0 warm
   H2D bytes, its cold time beside the host partition pass alone, the
   partitioned layout's bytes on each card of the placement (every one
   must hold its block, no other any) and each card's allocated bytes;
   (c) a governed ``QueryServer(max_shards=8)`` closed loop over Q-a with
   no failed or shed query, no over-budget event and every lane
   dispatched.
   The sharded program is plain PyTorch (the reference's per-shard body
   reaches no Pallas kernel), so it adds no kernel row;
6. LM serving on the card, three models in turn at full width in
   bfloat16, random weights made on the card from ``--seed``, each freed
   before the next (58.65 and 29.26 GiB do not fit together), counters
   from 0 for each: Phi-3.5-MoE (``phi3.5-moe-42b-a6.6b``) at 24 of its 32
   layers, DeepSeek-V2-Lite (``deepseek-v2-lite-16b``: MLA, 64 experts
   top-6 and 2 shared) at all 27 and Mamba2-370m (``mamba2-370m``) at all
   48.  Each: a prefill of 2 x 4096 tokens through ``make_prefill_step``
   (the bf16 flash-attention kernel on the tensor cores where the model
   attends, the MoE dispatch/combine kernels on the einsum path), with its
   model flops (the reference's formula) over the bf16 peak, then 8
   requests (prompt 64, 32 new tokens) through ``launch.serve``'s loop
   (``BatchScheduler(4)``, whose admission sort launches the radix sort
   kernel, and ``generate``, whose decode steps write K/V or MLA's
   compressed entry at the position and replace mamba's state); logits
   must be finite and every request served;
7. the smoke configs of Phi-3.5-MoE, Yi-9B, Gemma-2, DeepSeek-V2-Lite,
   Mamba2-370m and Jamba-1.5 on the card and on the CPU with the same
   float32 weights, counters from 0: prefill logits within 2e-4 and
   ``generate``'s tokens equal; the float32 attention kernel must run;
8. training on the card, counters from 0: the data pipeline
   (``repro_torch.data.pipeline``, the reference's defaults: 20,000
   documents, ``auto``, 1 MB of work_mem; its dedup join and packing sort
   through the relational engine on the card, and again under ``tensor``,
   which must give the same batch), then Phi-3.5-MoE at full width and 2
   of its 32 layers in float32 (2.86 B parameters with AdamW's state),
   three AdamW steps of 2 x 4096 tokens on the first batch repeated
   through ``make_train_step`` (the flash-attention forward writing its
   logsumexp, its backward kernel, the MoE dispatch/combine and their
   backward with the routing-weight gradient kernel), each step's loss,
   gradient norm, seconds, tokens/s and model flops (the reference's
   formula) as a share of the float32 and TF32 peaks, peak memory; then a
   checkpoint, a fourth step, a restart from the checkpoint and the fourth
   step again, which must equal the uninterrupted one.  Fails on a loss
   that is not finite, a parameter without a gradient or a third loss not
   below the first.  Then the same cut in bf16 on the emptied card: the
   float32 run's initial weights rounded to bf16, AdamW's state float32,
   3 + 1 steps (the bf16 flash-attention forward writing its logsumexp,
   the bf16 backward kernel, the MoE kernels on bf16 activations), no
   checkpoint; each step's s, tokens/s and model flops over the bf16 peak,
   peak memory, the launches a step; fails on a loss that is not finite or
   not falling, a parameter without a gradient, or a first loss farther
   than 2e-2 (relative) from the float32 run's;
9. the LM on a mesh (``--only dryrun``): the production dry-run
   (``repro_torch.launch.dryrun``) of Phi-3.5-MoE x train_4k and
   DeepSeek-V2-Lite x prefill_32k on the (16, 16) mesh starts in two
   processes of its own (fake process group, meta tensors, CPU only);
   meanwhile a process group of one rank over NCCL and
   ``make_local_mesh(1, 1)`` on the card, phase 8's model laid out by
   ``param_specs`` (its bytes equal to the dry-run's plan for the same
   cut on a (1, 1) mesh, the allocated ones apart from the allocator's
   rounding: 512-byte blocks, a large block keeping its 2 MiB segment's
   remainder of up to 1 MiB), 2 steps under the mesh through the hand kernels
   (counters from 0), the group torn down, and the same 2 steps unsharded
   from the same weights: losses within 1e-6; then each dry-run record
   (per-device argument and temp GiB, counted flops, useful-flops ratio,
   dominant roofline term; all predictions) must be ok;
10. four cards (``--only cards``, not in the default run; it fails with
   fewer than four): (1) Q-a as in 5b(b) with its eight partitions on 1
   (``device="cuda:0"``), 2 (``("cuda:0", "cuda:1")``) and 4 cards
   (``"cuda"``), each held to phase 3's oracle with 1 warm sync and 0
   warm H2D bytes, every card of the placement holding its block; (2)
   fig15's fragment at 1, 2, 4 and 8 shards over the four cards; (3) 5b's
   governed closed loop over the four cards; (4) phase 9's step on a
   (2, 2) mesh of four NCCL ranks, a card each (spawned here): each
   rank's bytes against the dry-run's plan for that mesh, the steps
   through the hand kernels with each rank's launches counted (the
   float32 attention forward and backward, dispatch, combine and the
   routing-weight gradient on every rank), the group torn down, the same
   steps unsharded on card 0 from the same weights: losses within 1e-4.
   Q-a takes 20 warm runs a placement here and the mesh 3 steps.

Phase 2 also holds the four LM kernels against their plain versions at
phase 6's shapes; their ``launches`` come from the phase 6 run of the
model named by the row's ``at`` (the float32 attention kernel's from
phase 7), the relational kernels' from phase 3; and the training path's
three (the float32 forward with its logsumexp, its backward, the
routing-weight gradient) at phase 8's shapes, launches from phase 8's
float32 run; and the bf16 training path's (the bf16 forward with its
logsumexp, the bf16 backward, also at DeepSeek-V2-Lite's MLA widths, and
the routing-weight gradient on bf16 activations), launches from phase 8's
bf16 run.

The script imports nothing of JAX.  The line before the last is the card as
``nvidia-smi`` names it; the last line is one JSON object with the device.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

SF1_ORDERS = 1_500_000
SF1_LINEITEM = 6_001_215
WARM_RUNS = 5            # warm runs per query; the p50 is over these
D_1992_01_01 = 8035      # TPC-H STARTDATE, days since 1970-01-01
D_1998_08_02 = 10440     # ENDDATE - 151 days (last O_ORDERDATE)
D_1995_03_15 = 9204      # TPC-H Q3's date
D_1995_06_17 = 9298      # TPC-H CURRENTDATE (§4.2.3)
LM_ARCH = "phi3.5-moe-42b-a6.6b"
LM_LAYERS = 24               # of 32: the bf16 weights fit one 80 GB card
#: phase 6's models, served one after the other on the emptied card: (arch,
#: layers run); Phi-3.5-MoE is cut to fit, the others run at full depth
LM_MODELS = ((LM_ARCH, LM_LAYERS), ("deepseek-v2-lite-16b", 27),
             ("mamba2-370m", 48))
#: device memory left allocated between two of phase 6's models, at most
LM_LEFT_BYTES = 1 << 30
PREFILL_BATCH, PREFILL_LEN = 2, 4096
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 64, 32
SMOKE_ARCHS = ("phi3.5-moe-42b-a6.6b", "yi-9b", "gemma2-9b",
               "deepseek-v2-lite-16b", "mamba2-370m", "jamba-1.5-large-398b")


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
    # §4.2.3: received 1..30 days after shipping; L_RETURNFLAG R or A at
    # random when received by CURRENTDATE, else N; L_LINESTATUS O when
    # shipped after CURRENTDATE, else F.  Q1's two CHAR(1) group keys are
    # one dictionary code here: flag (A, N, R) * 2 + status (F, O)
    l_receiptdate = l_shipdate + rng.integers(1, 31, n_l)
    flag = np.where(l_receiptdate <= D_1995_06_17,
                    2 * rng.integers(0, 2, n_l), 1)
    l_returnflag_linestatus = (2 * flag
                               + (l_shipdate > D_1995_06_17)).astype(np.int64)
    orders = {"orderkey": orderkey, "o_orderdate": o_orderdate,
              "o_custkey": custkey.astype(np.int64)}
    lineitem = {"orderkey": l_orderkey, "l_suppkey": l_suppkey,
                "l_shipdate": l_shipdate, "l_quantity": l_quantity,
                "l_extendedprice": l_extendedprice,
                "l_returnflag_linestatus": l_returnflag_linestatus}
    return orders, lineitem


def oracle(orders, lineitem):
    """The five answers with numpy alone: searchsorted join, masks,
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
    # Q-e: Q1's group keys and integer aggregates
    uniq, inv = np.unique(lineitem["l_returnflag_linestatus"],
                          return_inverse=True)
    qe = {"l_returnflag_linestatus": uniq}
    for c in ("l_quantity", "l_extendedprice"):
        qe[f"sum_{c}"] = np.zeros(len(uniq), np.float64)
        np.add.at(qe[f"sum_{c}"], inv, lineitem[c].astype(np.float64))
    qe["count_orderkey"] = np.bincount(inv).astype(np.float64)
    # Q-a's join core without its filter (phase 4b): every line has its order
    qj = int(lineitem["l_extendedprice"][hit].sum())
    return {"Q-a": qa, "Q-b": qb, "Q-c": qc, "Q-d": qd, "Q-e": qe,
            "Q-a join": qj}


QUERIES = ("Q-a", "Q-b", "Q-c", "Q-d", "Q-e")
#: the serving loops' mix (phase 4)
SERVED = ("Q-a", "Q-b", "Q-c", "Q-d")


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
        # Q1 without its date filter, which keeps 98.6% of the lines: the
        # port filters below a GROUP BY on the host, as the reference does
        "Q-e": sess.table("lineitem").group_by(
            "l_returnflag_linestatus", {"l_quantity": "sum",
                                        "l_extendedprice": "sum",
                                        "orderkey": "count"}),
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
    if name in ("Q-c", "Q-e"):  # groups in key order
        order = np.argsort(rel[next(iter(want))], kind="stable")
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


DECODE_CALLS = 200


def device_events(prof) -> list:
    """A trace's device events (kernels, copies, fills)."""
    import torch

    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


#: traces taken at most for one number: the card's profiler now and then
#: returns a session without its device events, or with part of them (five
#: traces of 200 calls have held 113, 0, 199, 200 and 198 events)
TRACE_TRIES = 8


def device_ms_per_call(fn, kernel_name, calls: int = DECODE_CALLS,
                       by_name: Optional[dict] = None):
    """The device time of one call of ``fn`` and the kernels it launches:
    torch.profiler's kernel times over ``calls`` calls issued back to back,
    divided by ``calls`` (CUDA events around them would time the host's
    enqueue when the host is the slower).  With ``kernel_name``, its launch
    counter must rise once a call.  A trace counts only where a second
    trace holds as many device events (a session that lost events, wholly
    or in part, agrees with no other); the two traces' mean is returned.
    Fails after ``TRACE_TRIES`` traces without two that agree.  A session
    of many events may drop its first one or two in every trace, so a
    count a call can read a little short (0.99 of 1 over 200 calls).
    ``by_name``, where given, receives for each device event name (a
    kernel's full name, template arguments and all) its mean time a launch
    over the two traces: a trace that drops a call's first events, as the
    card's profiler does now and then, leaves that mean as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import device as D

    fn()
    torch.cuda.synchronize()
    seen, seen_names = {}, {}
    for _ in range(TRACE_TRIES):
        before = D.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        if kernel_name is not None:
            launched = D.launch_counts()[kernel_name] - before[kernel_name]
            if launched != calls:
                fail(f"{kernel_name}: {launched} launches in {calls} calls")
        kernels = device_events(prof)
        total_us = sum(ev.device_time_total for ev in kernels)
        n = len(kernels)
        names = {}  # name -> (us, launches)
        for ev in kernels:
            us, c = names.get(ev.name, (0.0, 0))
            names[ev.name] = (us + ev.device_time_total, c + 1)
        if n and total_us > 0:
            if n in seen:
                if by_name is not None:
                    for k in set(names) | set(seen_names[n]):
                        us, c = names.get(k, (0.0, 0))
                        us2, c2 = seen_names[n].get(k, (0.0, 0))
                        by_name[k] = (us + us2) / (c + c2) / 1e3
                return (seen[n] + total_us) / 2 / calls / 1e3, n / calls
            seen[n] = total_us
            seen_names[n] = names
        if len(seen) != 1 or n not in seen:
            print(f"profiler trace: {n} device events over {calls} calls "
                  f"against {sorted(seen)}, traced again", flush=True)
    fail(f"{TRACE_TRIES} profiler traces, no two with the same count of "
         f"device events ({sorted(seen)})")


def host_ms_per_call(fn, calls: int = DECODE_CALLS) -> float:
    """The host's time to issue one call of ``fn``: ``calls`` calls back to
    back on the host clock, without a synchronise between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def bound(nbytes: int, ops: int, ops_per_s: Optional[float] = None):
    """Least time for the work: bytes over the memory rate vs operations
    over the peak rate, whichever is larger (``repro_torch.roofline.hw``:
    the H100 SXM's data sheet).  ``ops_per_s`` defaults to the float32
    rate outside the tensor cores, taken as the rate of the scalar integer
    and float64 operations of the kernels: an upper bound on it, so the
    operations bound is a lower bound."""
    from repro_torch.roofline import hw

    ops_per_s = hw.PEAK_FLOPS_F32 if ops_per_s is None else ops_per_s
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got, want) -> int:
    """Largest absolute difference over a kernel's integer outputs."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def join_inputs(orders, lineitem, dev) -> dict:
    """The codes the fused dense join hands the radix probe at Q-a's shape
    (planned by the engine's own ``_host_plan``): each side padded to its
    capacity bucket, padding and dead rows at the dead slot ``domain``;
    and the build side in radix order (``bk_ord``, ``brow``), as
    ``radix_hash_probe`` hands it to ``join_table_build``.  Calls only what
    every slice of the port offers."""
    import numpy as np
    import torch

    from repro_torch.core import Relation
    from repro_torch.core.fused import _host_plan
    from repro_torch.core.tensor_engine import capacity_bucket
    from repro_torch.kernels.segment_join import ops

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

    j = {"domain": domain, "bk0c": codes(orders["orderkey"], len(build)),
         "pk0c": codes(lineitem["orderkey"], len(probe))}
    dblk = ops.probe_block_size(domain)
    j["shift"] = dblk.bit_length() - 1
    j["nblocks"] = -(-(domain + 1) // dblk)
    j["dpad"] = j["nblocks"] * dblk
    j["ids_b"] = (j["bk0c"] >> j["shift"]).contiguous()
    j["ids_p"] = (j["pk0c"] >> j["shift"]).contiguous()
    bdest, _ = ops.radix_partition(j["ids_b"], j["nblocks"])
    j["bk_ord"], j["brow"] = ops._order(j["bk0c"], bdest)
    return j


def table_build_cases(K, ref, j, dev) -> dict:
    """``join_table_build`` at Q-a's build shape: as the main path hands it
    over (radix order, 28% of the rows at the dead slot), without the
    padding rows, in random order, and with all or half the rows at one
    code (random order).  Each held bit for bit against the plain version;
    returns {case: CUDA-event ms}."""
    import torch

    bk, brow, dpad = j["bk_ord"], j["brow"], j["dpad"]
    gen = torch.Generator(device=dev).manual_seed(11)
    n = bk.numel()
    shuffle = torch.randperm(n, generator=gen, device=dev)
    half = torch.randperm(n, generator=gen, device=dev)[: n // 2]
    keep = bk != j["domain"]
    rows = brow[shuffle].contiguous()
    cases = {
        "main_path": (bk, brow),
        "no_padding": (bk[keep].contiguous(), brow[keep].contiguous()),
        "random_order": (bk[shuffle].contiguous(), rows),
        "all_one_code": (torch.full_like(bk, 12345), rows),
        "half_one_code": (bk[shuffle].index_fill(0, half, 12345).contiguous(),
                          rows),
    }
    out = {}
    for what, (b, r) in cases.items():
        got = K.join_table_build(b, r, dpad)
        want = ref.join_table_build_ref(b, r, dpad)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail(f"join_table_build ({what}) disagrees with its plain "
                     f"version")
        out[what] = time_ms(lambda: K.join_table_build(b, r, dpad))
        print(f"join_table_build {what}: n={b.numel()}, slots={dpad}: "
              f"{out[what]:.4f} ms, equal to the plain version", flush=True)
    return out


def kernel_phase(orders, lineitem, dev):
    """Each kernel on the main path's inputs: the probe and build codes the
    fused dense join hands the radix probe (``join_inputs``), and the
    segment ids and values of the GROUP BY."""
    import torch

    from repro_torch.kernels.segment_join import kernel as K
    from repro_torch.kernels.segment_join import ops, ref

    j = join_inputs(orders, lineitem, dev)
    pk0c, domain = j["pk0c"], j["domain"]
    nblocks, dpad = j["nblocks"], j["dpad"]
    ids_b, ids_p = j["ids_b"], j["ids_p"]
    rows = []

    # radix_rank at the build side's shape (the main path's; the probe
    # side is probed in row order) and the probe side's, each against its
    # plain version; the row is the build side's
    err = 0
    rank_ms, rank_bound = {}, {}
    for side, ids in (("build", ids_b), ("probe", ids_p)):
        got = K.radix_rank(ids, nblocks)
        want = ref.radix_rank_ref(ids, nblocks)
        err = max(err, int_err(got, want))
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail(f"radix_rank ({side} side) disagrees with its plain "
                     f"version")
        n = ids.numel()
        rank_bound[side] = bound(n * 4 * 2 + nblocks * 4, n)
        rank_ms[side] = time_ms(lambda: K.radix_rank(ids, nblocks))
        print(f"radix_rank {side} side: n={n}, buckets={nblocks}: "
              f"{rank_ms[side]:.4f} ms, bound {rank_bound[side][0]:.4f} ms "
              f"by {rank_bound[side][1]}", flush=True)
    n = ids_b.numel()
    t_b, by = rank_bound["build"]
    rows.append({"name": "radix_rank", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:106",
                 "max_abs_err": err, "ms": rank_ms["build"],
                 "plain_ms": time_ms(lambda: ref.radix_rank_ref(ids_b,
                                                                nblocks)),
                 "bound_ms": t_b, "bound_by": by, "library_ms": None,
                 "probe_side_ms": rank_ms["probe"],
                 "probe_side_bound_ms": rank_bound["probe"][0],
                 "shape": f"n={n}, buckets={nblocks}, the build side (probe "
                          f"side n={ids_p.numel()}: {rank_ms['probe']:.4f} "
                          f"ms)"})

    # table build over the radix-ordered build side, and its other cases
    bk_ord, brow = j["bk_ord"], j["brow"]
    got = K.join_table_build(bk_ord, brow, dpad)
    want = ref.join_table_build_ref(bk_ord, brow, dpad)
    err = int_err(got, want)
    build_ms = table_build_cases(K, ref, j, dev)
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
                 "max_abs_err": err, "ms": build_ms["main_path"],
                 "plain_ms": time_ms(lambda: ref.join_table_build_ref(
                     bk_ord, brow, dpad)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(lib_build),
                 "cases_ms": build_ms,
                 "shape": f"n={n}, slots={dpad}, "
                          f"{int((bk_ord == domain).sum())} rows at the "
                          f"dead slot (without them: "
                          f"{build_ms['no_padding']:.4f} ms)"})

    # table probe: the main path's probe codes in their own row order
    # (lineitem's, as they come), one 8-byte gather a probe from the
    # build's (cnt, inv) pairs, count and build row straight out
    got = K.join_table_probe_rows(pk0c, cnt_t, inv_t)
    want = ref.join_table_probe_rows_ref(pk0c, cnt_t, inv_t)
    err = int_err(got, want)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail("join_table_probe disagrees with its plain version")
    pairs = cnt_t.as_strided((dpad, 2), (2, 1))  # the (cnt, inv) table
    pk_l = pk0c.long().clamp(0, dpad - 1)
    # the gathers read only the 32-byte sectors (4 slots each) of the table
    # that this run's codes fall in, not the whole table
    n = pk0c.numel()
    hit = pk0c[(pk0c >= 0) & (pk0c < dpad)]
    sectors = int(torch.unique(hit >> 2).numel())
    t_b, by = bound(n * 4 + sectors * 32 + n * 8, n)
    side = probe_side_cases(K, ops, ref, j, cnt_t, inv_t, dev)
    rows.append({"name": "join_table_probe", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:217",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: K.join_table_probe_rows(pk0c, cnt_t,
                                                               inv_t)),
                 "plain_ms": time_ms(lambda: ref.join_table_probe_rows_ref(
                     pk0c, cnt_t, inv_t)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(
                     lambda: torch.index_select(pairs, 0, pk_l)),
                 "probe_side_ms": side,
                 "shape": f"n={n}, slots={dpad}, sectors read={sectors}, "
                          f"probe codes in row order (shuffled: "
                          f"{side['new_shuffled']:.4f} ms)"})

    sum_cases, sum_err = segment_sum_cases(K, ref, lineitem, dev)
    main = sum_cases["cents_sorted"]   # Q-c's own sum
    rows.append({"name": "segment_sum", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_join.cu",
                 "replaces": "src/repro/kernels/segment_join/kernel.py:59",
                 "max_abs_err": sum_err, "ms": main["ms"],
                 "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"],
                 "cases": sum_cases,
                 "shape": f"n={main['n']}, segments={main['n']}, Q-c's "
                          f"sorted ids and integer cents ({main['route']} "
                          f"route); other cases under cases"})
    return rows


def probe_side_cases(K, ops, ref, j, cnt_t, inv_t, dev) -> dict:
    """The probe side of ``radix_hash_probe`` at Q-a's shape, given the
    build's table: the parent's composition (radix-order the probe codes,
    probe, gather both results back, subtract 1) against one row-order
    probe, with Q-a's probe codes as they come and with their rows
    shuffled (the worst case for L2); both held against the plain
    version.  Returns CUDA-event ms by composition and case."""
    import torch

    shift, nblocks = j["shift"], j["nblocks"]

    def parent(pk):
        pdest, _ = ops.radix_partition(pk >> shift, nblocks)
        pk_ord, _ = ops._order(pk, pdest)
        cnt_po, inv_po = K.join_table_probe(pk_ord, cnt_t, inv_t)
        back = pdest.long()
        return cnt_po[back], inv_po[back] - 1

    def new(pk):
        return K.join_table_probe_rows(pk, cnt_t, inv_t)

    gen = torch.Generator(device=dev).manual_seed(13)
    pk0c = j["pk0c"]
    codes = {"in_order": pk0c,
             "shuffled": pk0c[torch.randperm(pk0c.numel(), generator=gen,
                                             device=dev)].contiguous()}
    out = {}
    for what, pk in codes.items():
        want = ref.join_table_probe_rows_ref(pk, cnt_t, inv_t)
        for name, fn in (("parent", parent), ("new", new)):
            if not all(torch.equal(g, w) for g, w in zip(fn(pk), want)):
                fail(f"the probe side ({name} composition, {what}) "
                     f"disagrees with its plain version")
            key = f"{name}_{what}"
            out[key] = time_ms(lambda: fn(pk))
            out[key + "_device"], out[key + "_kernels"] = \
                device_ms_per_call(lambda: fn(pk), None, 20)
        print(f"probe side {what}: parent composition "
              f"{out['parent_' + what]:.4f} ms (device "
              f"{out['parent_' + what + '_device']:.4f} ms in "
              f"{out['parent_' + what + '_kernels']:g} kernels), row-order "
              f"probe {out['new_' + what]:.4f} ms (device "
              f"{out['new_' + what + '_device']:.4f} ms in "
              f"{out['new_' + what + '_kernels']:g}), both equal to the "
              f"plain version", flush=True)
    return out


def segment_sum_call(K, ids, v, S: int):
    """``K.segment_sum`` over ``(ids, v)`` as a call of no arguments.  A
    checkout whose kernel takes the caller's ``ids_sorted`` gets True where
    the ids never decrease, as its GROUP BY passed it."""
    import inspect

    if "ids_sorted" in inspect.signature(K.segment_sum).parameters:
        word = bool((ids[1:] >= ids[:-1]).all())
        return lambda: K.segment_sum(ids, v, S, word)
    return lambda: K.segment_sum(ids, v, S)


def segment_sum_cases(K, ref, lineitem, dev, with_route: bool = True):
    """``segment_sum`` at Q-c's shape (the GROUP BY's sorted segment ids of
    l_suppkey over lineitem, as many segments as rows): non-integer
    float64 values from --seed (so that the order of the adds shows in the
    bits) sorted, with one segment holding half the rows, and unsorted;
    all-ones values (Q-c's counts); and Q-c's own integer cents sorted,
    skewed and unsorted.  Each is held bit for bit against the plain
    version on the CPU (index_add_ there adds in row order; on the card it
    is atomics), three runs; with ``with_route`` the route the card took
    (``kernel.segment_sum_route``) must be the one the plain predicate
    gives.  Returns ({case: numbers}, the largest |card - CPU|)."""
    import torch

    keys = torch.from_numpy(lineitem["l_suppkey"]).to(dev)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    newseg = torch.ones_like(sk, dtype=torch.bool)
    newseg[1:] = sk[1:] != sk[:-1]
    seg = (torch.cumsum(newseg.to(torch.int32), 0, dtype=torch.int32)
           - 1).contiguous()
    S = seg.numel()
    groups = int(seg[-1]) + 1
    gen = torch.Generator(device=dev).manual_seed(7)
    cents = torch.from_numpy(lineitem["l_extendedprice"]).to(dev).to(
        torch.float64)[order].contiguous()
    vals = (cents / 100.0 * (1.0 + 1e-3 * torch.randn(
        S, generator=gen, device=dev, dtype=torch.float64))).contiguous()
    skew = seg.clone()
    skew[S // 4: S // 4 + S // 2] = skew[S // 4]
    skew = torch.sort(skew).values.contiguous()
    shuffle = torch.randperm(S, generator=gen, device=dev)
    unsorted = seg[shuffle].contiguous()
    cases = {"sorted": (seg, vals),
             "skewed": (skew, vals),
             "unsorted": (unsorted, vals[shuffle].contiguous()),
             "count": (seg, torch.ones_like(vals)),   # Q-c's counts
             "cents_sorted": (seg, cents),            # Q-c's sum
             "cents_skewed": (skew, cents),
             "cents_unsorted": (unsorted, cents[shuffle].contiguous())}
    # bytes: ids and values read once, the sums written once; one add a row
    t_b, by = bound(S * 12 + S * 8, S)
    lib_out = torch.zeros(S, dtype=torch.float64, device=dev)
    out, err = {}, 0.0
    for what, (ids, v) in cases.items():
        want = ref.segment_sum_ref(ids.cpu(), v.cpu(), S)
        call = segment_sum_call(K, ids, v, S)
        route = None
        for _ in range(3):  # the same bits run after run
            if with_route:
                got, route = K.segment_sum_route(ids, v, S)
            else:
                got = call()
            got = got.cpu()
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
                fail(f"segment_sum ({what}) differs from its plain version "
                     f"on the CPU in {int((got != want).sum())} segments")
        if with_route:
            nondecreasing = bool((ids[1:] >= ids[:-1]).all())
            expect = ("exact" if ref.sum_is_order_free_ref(v.cpu()) else
                      "runs" if nondecreasing else "grouped")
            if route != expect:
                fail(f"segment_sum ({what}) took the {route} route, the "
                     f"plain predicate says {expect}")
        ids_l = ids.long()
        reps = 5 if what == "skewed" else 20
        ms = time_ms(call, reps)
        dev_ms, n_kernels = device_ms_per_call(call, None, reps)
        out[what] = {"n": S, "route": route, "ms": ms, "device_ms": dev_ms,
                     "kernels_per_call": n_kernels,
                     "host_ms": host_ms_per_call(call, reps),
                     "bound_ms": t_b, "bound_by": by,
                     "library_ms": time_ms(
                         lambda: lib_out.zero_().index_add_(0, ids_l, v)),
                     "plain_ms": time_ms(
                         lambda: ref.segment_sum_ref(ids, v, S))}
        print(f"segment_sum {what}: n={S}, segments={S} ({groups} groups"
              f"{', one of them half the rows' if 'skewed' in what else ''}"
              f"), route {route}: {ms:.4f} ms (device {dev_ms:.4f} ms in "
              f"{n_kernels:g} kernels, host {out[what]['host_ms']:.4f} ms a "
              f"call; index_add_ {out[what]['library_ms']:.4f} ms, bound "
              f"{t_b:.4f} ms), equal bit for bit to the plain version on the "
              f"CPU", flush=True)
    return out, err


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
    # the pass sorts only on the 8-bit digits in which the keys differ,
    # decided on the device: the passes that ran must be the digits the
    # plain version finds varying (3 of 8 for o_custkey, 2 of 4 for
    # o_orderdate), and columns that vary in chosen digits only must give
    # the plain version's permutation, with and without an incoming one
    passes = {}
    for name, col in (("o_custkey", ck_f), ("o_orderdate", od_f)):
        _, ran = K.digit_passes_run(col)
        if ran != ref.digit_mask_ref(col):
            fail(f"radix_sort_pass on {name} ran digit passes {ran:#x}, the "
                 f"varying digits are {ref.digit_mask_ref(col):#x}")
        passes[name] = f"{bin(ran).count('1')} of {col.element_size()}"
        print(f"sort {name}: {passes[name]} digit passes ran (mask "
              f"{ran:#x})", flush=True)
    n = ck_f.numel()
    gen = torch.Generator(device=dev).manual_seed(1)
    small = torch.randint(0, 256, (n,), generator=gen, device=dev)
    cases = {
        "all equal": torch.full((n,), 150_000, dtype=torch.int64,
                                device=dev),
        "top digit only": small << 56,
        "lowest digit only": (1234 << 8) + small,
        "negative only": -1 - ck_f,
        "-0.0, +0.0, NaN": torch.where(
            small < 85, -0.0, torch.where(small < 170, 0.0, float("nan"))
        ).to(torch.float32),
    }
    perm = torch.randperm(n, generator=gen, device=dev)
    for what, col in cases.items():
        for p in (None, perm):
            got, ran = K.digit_passes_run(col, p)
            if not torch.equal(got, ref.radix_sort_pass_ref(col, p)):
                fail(f"radix_sort_pass on a column with {what} (perm "
                     f"{p is not None}) disagrees with its plain version")
            if ran != ref.digit_mask_ref(col):
                fail(f"radix_sort_pass on a column with {what} ran digit "
                     f"passes {ran:#x}, not {ref.digit_mask_ref(col):#x}")
            err = max(err, int_err((got,), (ref.radix_sort_pass_ref(col, p),)))
    print(f"sort constant-digit cases ({', '.join(cases)}), with and "
          f"without perm: equal to the plain version", flush=True)
    t_b, by = bound(n * 8 + n * 8, n)
    return {"name": "radix_sort_pass", "route": "cuda",
            "source": "src/repro_torch/csrc/multikey_sort.cu",
            "replaces": "src/repro/kernels/multikey_sort/kernel.py:56",
            "max_abs_err": err,
            "ms": time_ms(lambda: K.radix_sort_pass(ck_f)),
            "plain_ms": time_ms(lambda: ref.radix_sort_pass_ref(ck_f), 5),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(lambda: torch.sort(ck_f, stable=True)),
            "digit_passes": passes["o_custkey"],
            "shape": f"n={n}, int64 key (o_custkey of Q-d's rows), "
                     f"{passes['o_custkey']} digit passes ran "
                     f"(o_orderdate: {passes['o_orderdate']})"}


ATTN_F32_TOL = 2e-5
ATTN_BF16_ATOL, ATTN_BF16_RTOL = 2e-3, 2.0 ** -6


def attn_err(got, want, what: str) -> float:
    """Holds flash attention's output against its plain version (float32:
    within ``ATTN_F32_TOL``; bf16: each element within ``ATTN_BF16_ATOL +
    ATTN_BF16_RTOL * |want|``), prints the check and returns the max abs
    error."""
    import torch

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        allowed = torch.full_like(diff, ATTN_F32_TOL)
        tol = f"{ATTN_F32_TOL}"
    else:
        allowed = ATTN_BF16_ATOL + ATTN_BF16_RTOL * want.float().abs()
        tol = f"{ATTN_BF16_ATOL} + {ATTN_BF16_RTOL} * |plain|"
    err = float(diff.max())
    worst = float((diff / allowed).max())
    print(f"flash_attention check {what}: max abs err {err:.3g}, worst "
          f"err / allowed {worst:.3g} (tol {tol}), mean |plain| "
          f"{float(want.float().abs().mean()):.3g}", flush=True)
    if not worst <= 1.0:
        fail(f"flash_attention ({what}) disagrees with its plain version: "
             f"max abs err {err}, worst err / allowed {worst} (tol {tol})")
    return err


#: phase 2's attention shapes, those of phase 6's prefills: (model, B, S,
#: H, KH, D, Dv, dtypes).  Phi-3.5-MoE's GQA in bf16 (its prefill) and
#: float32 (phase 7's kernel); DeepSeek-V2-Lite's MLA in bf16: q and k 192
#: wide, v 128, 16 heads with no grouping
ATTN_SHAPES = (
    (LM_ARCH, PREFILL_BATCH, PREFILL_LEN, 32, 8, 128, 128,
     ("bfloat16", "float32")),
    ("deepseek-v2-lite-16b", PREFILL_BATCH, PREFILL_LEN, 16, 16, 192, 128,
     ("bfloat16",)),
)
#: phase 2's MoE layer shapes, those of phase 6's prefills: Phi-3.5-MoE's
#: top-2 of 16 experts (d 4096) and DeepSeek-V2-Lite's top-6 of 64 (d 2048)
MOE_ARCHS = (LM_ARCH, "deepseek-v2-lite-16b")


def lm_kernel_phase(dev, seed: int):
    """The LM path's kernels at the shapes of phase 6's prefills (each
    row's ``at`` names the model): flash attention over 2 x 4096 tokens of
    Phi-3.5-MoE's heads (32 query, 8 kv, head dim 128, causal) in bf16 (the
    tensor-core kernel, phase 6's) and in float32 (the 3xTF32 kernel, phase
    7's), and of DeepSeek-V2-Lite's MLA heads (16, D 192, Dv 128) in bf16;
    one routing slot's dispatch and the combine over all k slots of a real
    top-k routing of 8192 tokens, at Phi-3.5-MoE's shape (d 4096, 16
    experts top-2, capacity 1280) and DeepSeek-V2-Lite's (d 2048, 64
    experts top-6, capacity 960).  Tolerances: attention in float32 within
    2e-5 (the reference tests'); in bf16 each output within
    ``ATTN_BF16_ATOL + ATTN_BF16_RTOL * |plain|``, two bf16 steps of its
    own size, since at S 4096 a typical output is about 0.04 and the
    reference tests' 3e-2 (set at S <= 256) would pass a wrong kernel;
    exact agreement for dispatch/combine, whose kernels and plain versions
    sum in the same order (float32 duplicates included)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert
    from repro_torch.roofline import hw

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    # flash attention at the prefills' shapes, each against its plain
    # version and SDPA in its dtype; float32's least time is the smaller of
    # the flops at the CUDA cores' float32 rate and three times the flops at
    # the TF32 rate
    routes = {
        "bfloat16": ("flash_attention", hw.PEAK_FLOPS_BF16,
                     "src/repro_torch/csrc/flash_attention_sm90.cu"),
        "float32": ("flash_attention_f32",
                    max(hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_TF32 / 3),
                    "src/repro_torch/csrc/flash_attention.cu"),
    }
    for at, B, S, H, KH, Dh, Dv, dtypes in ATTN_SHAPES:
        q, k, v = randn(B, S, H, Dh), randn(B, S, KH, Dh), randn(B, S, KH, Dv)
        scale = Dh ** -0.5
        pairs = B * H * S * (S + 1) // 2
        for dtype_name in dtypes:
            name, peak, source = routes[dtype_name]
            dtype = getattr(torch, dtype_name)
            q, k, v = (t.to(dtype) for t in (q, k, v))
            if FK.select_kernel(q, k, v) != name:
                fail(f"{dtype} attention does not select the {name} kernel")

            def flash():
                return FK.flash_attention_fwd(q, k, v, causal=True,
                                              scale=scale)

            got = flash()
            want = FR.flash_attention_ref(q, k, v, causal=True, scale=scale)
            err = attn_err(got, want, f"causal, D={Dh}, Dv={Dv}, S={S}, "
                                      f"{dtype}")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            # with grouped heads SDPA is timed twice, as it comes
            # (enable_gqa) and with K/V repeated to H heads, as row 6b-lse
            # calls it: the two may take different backends, and the
            # faster is the yardstick
            calls = {"enable_gqa": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale,
                enable_gqa=H != KH)}
            if H != KH:
                kr, vr = (t.repeat_interleave(H // KH, dim=1)
                          for t in (kt, vt))
                calls["K/V repeated"] = (
                    lambda: F.scaled_dot_product_attention(
                        qt, kr, vr, is_causal=True, scale=scale))
            lib_ms = {how: time_ms(fn) for how, fn in calls.items()}
            lib_how = min(lib_ms, key=lib_ms.get)
            library = calls[lib_how]
            lib_err = float((library().transpose(1, 2).float()
                             - want.float()).abs().max())
            t_b, by = bound(q.element_size() * (q.numel() + k.numel()
                                                + v.numel() + got.numel()),
                            2 * (Dh + Dv) * pairs, peak)
            rows.append({"name": name, "at": at, "route": "cuda",
                         "source": source,
                         "replaces":
                             "src/repro/kernels/flash_attention/kernel.py:70",
                         "max_abs_err": err, "ms": time_ms(flash),
                         "plain_ms": time_ms(lambda: FR.flash_attention_ref(
                             q, k, v, causal=True, scale=scale)),
                         "bound_ms": t_b, "bound_by": by,
                         "library_ms": lib_ms[lib_how],
                         "library_ms_by_call": lib_ms,
                         "shape": f"B={B}, S={S}, H={H}, KH={KH}, D={Dh}, "
                                  f"Dv={Dv}, {dtype}, causal (library: SDPA "
                                  f"with {lib_how}, the faster of "
                                  f"{len(lib_ms)}; it differs from the "
                                  f"plain version by {lib_err:.3g})"})
            del qt, kt, vt, got, want, library, calls
            if H != KH:
                del kr, vr
        del q, k, v
    # check only: Gemma-2's heads (16 query, 8 kv, head dim 256) with a
    # window and the tanh soft-cap, cut to 1024 tokens (window 512 so
    # that it masks), in bf16 and float32
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (randn(1, 1024, h, 256, dtype=dtype) for h in (16, 8, 8))
        kw = dict(causal=True, window=512, cap=50.0, scale=256 ** -0.5)
        attn_err(FK.flash_attention_fwd(q, k, v, **kw),
                 FR.flash_attention_ref(q, k, v, **kw),
                 f"D=256, window=512, cap=50, {dtype}")

    # the combine of the layer body: all k slots of the routing as the
    # layer has it (int64 experts and float32 weights as column slices,
    # int32 slots) over the buffer all slots were dispatched into; held bit
    # for bit against the plain version and against the k single-slot
    # kernels added in turn
    def combine_case(xs, idx, wk, E, Cs):
        d = xs.shape[1]
        sk = MO.expert_slots(idx, E)
        b = MK.moe_dispatch(xs, idx[:, 0], sk[:, 0], E, Cs)
        for j in range(1, idx.shape[1]):
            b = MK.moe_dispatch(xs, idx[:, j], sk[:, j], E, Cs, into=b)
        y = MO.combine_slots(b, idx, sk, wk)
        want = MR.combine_slots_ref(b, idx, sk, wk)
        k_call = None
        for j in range(idx.shape[1]):
            c = MK.moe_combine(b, idx[:, j], sk[:, j], wk[:, j])
            k_call = c if k_call is None else k_call + c
        err = float((y.float() - want.float()).abs().max())
        if not (torch.equal(y, want) and torch.equal(y, k_call)):
            fail(f"moe_combine over {idx.shape[1]} slots disagrees with its "
                 f"plain version at T={xs.shape[0]}, E={E} (max |err| "
                 f"{err})")
        keep = sk < Cs
        flat = b.reshape(E * Cs, d)
        rows_k = torch.where(keep, idx * Cs + sk, 0).reshape(-1)
        w_b = torch.where(keep, wk.to(b.dtype), 0)[..., None]
        T_, k_ = idx.shape

        def library():  # index_select · mul · add
            g = torch.index_select(flat, 0, rows_k).view(T_, k_, d) * w_b
            out = g[:, 0]
            for j in range(1, k_):
                out = out + g[:, j]
            return out

        kept_k = int(keep.sum())
        return (lambda: MO.combine_slots(b, idx, sk, wk),
                lambda: MR.combine_slots_ref(b, idx, sk, wk), library,
                bound(kept_k * d * 2 + T_ * k_ * 16 + T_ * d * 2,
                      (2 * k_ - 1) * T_ * d), kept_k, err)

    prefill = {}   # (name, model) -> (kernel call, library call)
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        T, d, E = PREFILL_BATCH * PREFILL_LEN, cfg.d_model, cfg.num_experts
        k = cfg.experts_per_token
        C = capacity_per_expert(T, E, k, cfg.capacity_factor)
        x = randn(T, d)
        router = randn(d, E, dtype=torch.float32) / d ** 0.5
        topk_idx, topk_w, _ = _route({"router": router}, x, cfg)
        slot = MO.expert_slots(topk_idx, E)
        # dispatch on one routing slot, reading the routing's column views
        # as the layer body hands them over (int64 experts, int32 slots,
        # stride k)
        e_view, s_view = topk_idx[:, 0], slot[:, 0]
        eidx = e_view.to(torch.int32).contiguous()
        sl = s_view.contiguous()
        buf = MK.moe_dispatch(x, e_view, s_view, E, C)
        err = float((buf.float() - MR.dispatch_ref(x, eidx, sl, E, C).float())
                    .abs().max())
        if err != 0.0:
            fail(f"moe_dispatch disagrees with its plain version at {arch}'s "
                 f"shape: {err}")
        both = MK.moe_dispatch(x, topk_idx[:, 1], slot[:, 1], E, C,
                               into=buf.clone())
        if not torch.equal(both, buf + MR.dispatch_ref(x, topk_idx[:, 1],
                                                       slot[:, 1], E, C)):
            fail("moe_dispatch adding the second slot into the first is not "
                 "buf + b")
        keep = sl < C
        kept = int(keep.sum())
        rows_all = torch.where(keep, eidx.long() * C + sl.long(), E * C)
        lib_buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)

        def lib_dispatch(lib_buf=lib_buf, rows_all=rows_all, x=x):
            lib_buf.zero_().index_put_((rows_all,), x, accumulate=True)

        def dispatch_call(x=x, e_view=e_view, s_view=s_view, E=E, C=C):
            return MK.moe_dispatch(x, e_view, s_view, E, C)

        t_b, by = bound(kept * d * 2 + T * 8 + E * C * d * 2, kept * d)
        rows.append({"name": "moe_dispatch", "at": arch, "route": "cuda",
                     "source": "src/repro_torch/csrc/moe_dispatch.cu",
                     "replaces":
                         "src/repro/kernels/moe_dispatch/kernel.py:53",
                     "max_abs_err": err, "ms": time_ms(dispatch_call),
                     "plain_ms": time_ms(
                         lambda: MR.dispatch_ref(x, e_view, s_view, E, C)),
                     "bound_ms": t_b, "bound_by": by,
                     "library_ms": time_ms(lib_dispatch),
                     "shape": f"T={T}, d={d}, E={E}, C={C}, bf16, slot 0 of "
                              f"top-{k}, {kept} routed rows, routing column "
                              f"views"})
        call, plain, lib_combine, (t_b, by), kept_k, combine_err = \
            combine_case(x, topk_idx, topk_w, E, C)
        rows.append({"name": "moe_combine", "at": arch, "route": "cuda",
                     "source": "src/repro_torch/csrc/moe_dispatch.cu",
                     "replaces":
                         "src/repro/kernels/moe_dispatch/kernel.py:98",
                     "max_abs_err": combine_err, "ms": time_ms(call),
                     "plain_ms": time_ms(plain),
                     "bound_ms": t_b, "bound_by": by,
                     "library_ms": time_ms(lib_combine),
                     "shape": f"T={T}, d={d}, E={E}, C={C}, bf16, all {k} "
                              f"slots, {kept_k} routed rows"})
        prefill[("moe_dispatch", arch)] = (dispatch_call, lib_dispatch)
        prefill[("moe_combine", arch)] = (call, lib_combine)
        if arch == LM_ARCH:
            decode, kept_at_decode, decode_err = moe_decode_calls(
                cfg, router, randn, combine_case)

    for r in rows:  # the larger of the prefill and decode readings
        if r["name"] == "moe_combine" and r["at"] == LM_ARCH:
            r["max_abs_err"] = max(r["max_abs_err"], decode_err)
    # host times first, for every call: the profiler's tracing is not
    # running then
    host = {name: (host_ms_per_call(call), host_ms_per_call(library))
            for name, (call, library, _) in decode.items()}
    for r in rows:
        if r["at"] == LM_ARCH and r["name"] in decode:
            call, library, (t_b, by) = decode[r["name"]]
            host_ms, lib_host_ms = host[r["name"]]
            dev_ms, n_kernels = device_ms_per_call(call, r["name"])
            lib_dev_ms, lib_kernels = device_ms_per_call(library, None)
            r.update(decode_device_ms=dev_ms, decode_host_ms=host_ms,
                     decode_library_device_ms=lib_dev_ms,
                     decode_library_host_ms=lib_host_ms,
                     decode_kernels_per_call=n_kernels,
                     decode_bound_ms=t_b)
            print(f"{r['name']} at decode shape ({kept_at_decode[r['name']]})"
                  f": device {dev_ms:.6f} ms a call ({n_kernels} kernels), "
                  f"host {host_ms:.4f} ms a call; library device "
                  f"{lib_dev_ms:.6f} ms ({lib_kernels} kernels), host "
                  f"{lib_host_ms:.4f} ms; bound {t_b:.6f} ms by {by}",
                  flush=True)
    # the prefill shapes' device time, from the profiler (CUDA events
    # around one call also time the host's enqueue while the card waits)
    for r in rows:
        if (r["name"], r["at"]) in prefill:
            call, library = prefill[(r["name"], r["at"])]
            r["device_ms"], r["kernels_per_call"] = device_ms_per_call(
                call, r["name"], 20)
            r["library_device_ms"], _ = device_ms_per_call(library, None, 20)
            print(f"{r['name']} at {r['at']}'s prefill shape: device "
                  f"{r['device_ms']:.4f} ms a call ({r['kernels_per_call']} "
                  f"kernels), library device "
                  f"{r['library_device_ms']:.4f} ms", flush=True)
    # duplicate and dropped slots, float32: exact
    xs = randn(2000, 256, dtype=torch.float32)
    es = torch.randint(-1, 5, (2000,), generator=gen, device=dev,
                       dtype=torch.int32)
    ss = torch.randint(-1, 40, (2000,), generator=gen, device=dev,
                       dtype=torch.int32)
    if not torch.equal(MK.moe_dispatch(xs, es, ss, 4, 32),
                       MR.dispatch_ref(xs, es, ss, 4, 32)):
        fail("moe_dispatch with duplicate slots (float32) is not exact")
    return rows


#: phase 8's training shapes: Phi-3.5-MoE at full width, 2 of its 32
#: layers, float32 and then bf16, 2 x 4096 tokens a step
TRAIN_LAYERS = 2
TRAIN_AT = "phi3.5-moe-train"
TRAIN_AT_BF16 = "phi3.5-moe-train-bf16"
#: the bf16 backward at DeepSeek-V2-Lite's MLA widths; its launches are
#: the bf16 training run's (phase 8 trains Phi-3.5-MoE only)
TRAIN_AT_MLA = "deepseek-v2-lite-widths-bf16"
TRAIN_GRAD_TOL = 1e-4     # the backward, of each gradient's largest |value|
WGRAD_TOL = 1e-5          # the routing-weight gradient, the same
#: the bf16 forward's logsumexp against its plain version (absolute; the
#: kernel's exponentials and row sums are float32, in another order)
LSE_BF16_TOL = 1e-3
#: the bf16 backward's dq, dk, dv, of each gradient's largest |plain|: P
#: and dS are rounded to bf16 (2^-9 relative) as operands of the gradient
#: products and each gradient is stored in bf16; the plain version keeps
#: float32 throughout
TRAIN_GRAD_TOL_BF16 = 2.0 ** -6


def train_kernel_phase(dev, seed: int):
    """The training path's new kernels at phase 8's shapes, each against
    its plain version on the same inputs: the float32 forward writing its
    row logsumexp (Phi-3.5-MoE's heads, B 2, S 4096, causal; output and
    logsumexp within ``ATTN_F32_TOL``), the backward kernel at that shape
    (dq, dk, dv within ``TRAIN_GRAD_TOL`` of the plain version's largest
    magnitude; SDPA's forward + backward minus its forward beside it),
    and ``moe_combine_weight_grad`` over a real top-2 routing of 8192
    tokens (E 16, C 1280, d 4096, float32; within ``WGRAD_TOL``).  The
    backward's bound counts five products (S, dP, dV, dK, dQ: 2.5 times
    the forward's flops) at the rate row 6b uses; its row also carries the
    device time of each of its kernels (``delta_kernel``, the dK/dV pass
    ``dkdv_kernel`` and the dQ pass ``dq_kernel``), from profiler traces.
    Then the bf16 training path's rows (:func:`train_bf16_kernel_rows`)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert
    from repro_torch.roofline import hw

    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    rows = []
    B, S, H, KH, Dh = PREFILL_BATCH, PREFILL_LEN, 32, 8, 128
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, S, H, Dh), (B, S, KH, Dh),
                                 (B, S, KH, Dh), (B, S, H, Dh)))
    scale = Dh ** -0.5
    pairs = B * H * S * (S + 1) // 2
    f32_rate = max(hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_TF32 / 3)
    shape = f"B={B}, S={S}, H={H}, KH={KH}, D={Dh}, Dv={Dh}, float32, causal"

    def fwd():
        return FK.flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                      return_lse=True)

    out, lse = fwd()
    r_out, r_lse = FR.flash_attention_ref(q, k, v, causal=True, scale=scale,
                                          return_lse=True)
    err_o = attn_err(out, r_out, f"with its logsumexp, {shape}")
    err_l = float((lse - r_lse).abs().max())
    if not err_l <= ATTN_F32_TOL:
        fail(f"flash_attention_f32's logsumexp differs from its plain "
             f"version by {err_l}")
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kr, vr = (t.repeat_interleave(H // KH, dim=1) for t in (kt, vt))
    leaves = [t.detach().requires_grad_(True) for t in (qt, kr, vr)]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              scale=scale)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), leaves, dot)

    sdpa_fwd_ms = time_ms(sdpa_fwd, 5)
    t_b, by = bound(4 * (q.numel() + k.numel() + v.numel() + out.numel()
                         + lse.numel()), 2 * (2 * Dh) * pairs, f32_rate)
    rows.append({"name": "flash_attention_f32", "at": TRAIN_AT,
                 "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
                 "max_abs_err": max(err_o, err_l), "ms": time_ms(fwd, 10),
                 "plain_ms": time_ms(lambda: FR.flash_attention_ref(
                     q, k, v, causal=True, scale=scale, return_lse=True), 3),
                 "bound_ms": t_b, "bound_by": by, "library_ms": sdpa_fwd_ms,
                 "shape": f"{shape}, with the row logsumexp (SDPA forward "
                          f"with grad, K/V repeated to {H} heads)"})
    del r_out

    def bwd():
        return FK.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                      scale=scale)

    got = bwd()
    want = FR.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                                      scale=scale)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    worst = max(e / float(b.abs().max()) for e, b in zip(errs, want))
    print(f"flash_attention_bwd_f32 check {shape}: max abs err dq/dk/dv "
          f"{[f'{e:.3g}' for e in errs]}, worst over the largest |plain| "
          f"{worst:.3g} (tol {TRAIN_GRAD_TOL})", flush=True)
    if not worst <= TRAIN_GRAD_TOL:
        fail(f"flash_attention_bwd_f32 disagrees with its plain version: "
             f"{worst} of the largest magnitude")
    del got, want
    t_b, by = bound(4 * (q.numel() + k.numel() + v.numel() + 2 * out.numel()
                         + lse.numel() + q.numel() + k.numel() + v.numel()),
                    2 * (3 * Dh + 2 * Dh) * pairs, f32_rate)
    plain_ms = time_ms(lambda: FR.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True, scale=scale), 3)
    # the device time of each of the backward's kernels (its passes; each
    # launches once a call), and their sum
    bwd_device_ms, passes = _bwd_passes(
        bwd, FK.BWD_KERNEL, ("delta_kernel", "dkdv_kernel", "dq_kernel"))
    rows.append({"name": FK.BWD_KERNEL, "at": TRAIN_AT, "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
                 "max_abs_err": max(errs), "ms": time_ms(bwd, 10),
                 "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(sdpa_fwd_bwd, 5) - sdpa_fwd_ms,
                 "device_ms": bwd_device_ms, "pass_device_ms": passes,
                 "err_of_largest": worst,
                 "shape": f"{shape}; library: SDPA forward + backward "
                          f"minus its forward, K/V repeated to {H} heads"})
    del q, k, v, do, out, lse, qt, kt, vt, dot, kr, vr, leaves

    cfg = get_config(LM_ARCH)
    T, d, E = PREFILL_BATCH * PREFILL_LEN, cfg.d_model, cfg.num_experts
    kk = cfg.experts_per_token
    C = capacity_per_expert(T, E, kk, cfg.capacity_factor)
    x = torch.randn((T, d), generator=gen, device=dev)
    router = torch.randn((d, E), generator=gen, device=dev) / d ** 0.5
    topk_idx, _, _ = _route({"router": router}, x, cfg)
    slot = MO.expert_slots(topk_idx, E)
    buf = torch.randn((E, C, d), generator=gen, device=dev)
    dy = torch.randn((T, d), generator=gen, device=dev)

    def wgrad():
        return MK.moe_combine_weight_grad(dy, buf, topk_idx, slot)

    got = wgrad()
    want = MR.combine_weight_grad_ref(dy, buf, topk_idx, slot)
    err = float((got - want).abs().max())
    if not err <= WGRAD_TOL * float(want.abs().max()):
        fail(f"moe_combine_weight_grad disagrees with its plain version by "
             f"{err} (largest |plain| {float(want.abs().max())})")
    keep = slot < C
    kept = int(keep.sum())
    flat = buf.reshape(E * C, d)
    rows_k = torch.where(keep, topk_idx * C + slot, 0).reshape(-1)

    def library():  # index_select · mul · sum, dropped slots zeroed
        g = torch.index_select(flat, 0, rows_k).view(T, kk, d)
        return (g * dy[:, None]).sum(-1) * keep

    t_b, by = bound(4 * (T * d + kept * d + T * kk), 2 * kept * d)
    rows.append({"name": "moe_combine_weight_grad", "at": TRAIN_AT,
                 "route": "cuda",
                 "source": "src/repro_torch/csrc/moe_dispatch.cu",
                 "replaces": "src/repro/kernels/moe_dispatch/kernel.py:98",
                 "max_abs_err": err, "ms": time_ms(wgrad),
                 "plain_ms": time_ms(lambda: MR.combine_weight_grad_ref(
                     dy, buf, topk_idx, slot)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(library),
                 "shape": f"T={T}, k={kk}, d={d}, E={E}, C={C}, float32, "
                          f"{kept} routed rows"})
    return rows + train_bf16_kernel_rows(dev, seed)


def _bwd_passes(fn, kernel_name: str, what: tuple) -> tuple:
    """The device time of one call of a backward ``fn`` and of each of its
    kernels, named by the substrings ``what`` (each launches once a call),
    from two profiler traces that agree."""
    by_name = {}
    device_ms_per_call(fn, kernel_name, 5, by_name)
    passes = {}
    for w in what:
        hits = [ms for name, ms in by_name.items() if w in name]
        if len(hits) != 1:
            fail(f"{kernel_name}: {len(hits)} traced kernels named {w} "
                 f"({sorted(by_name)})")
        passes[w] = hits[0]
    total = sum(passes.values())
    print(f"{kernel_name} device time {total:.4f} ms a call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()),
          flush=True)
    return total, passes


def train_bf16_kernel_rows(dev, seed: int):
    """The bf16 training path's kernels at phase 8's shapes, each against
    its plain version on the same inputs: the bf16 forward writing its row
    logsumexp (row 6-lse; Phi-3.5-MoE's heads, B 2, S 4096, causal), whose
    output must equal the forward without it bit for bit and whose
    logsumexp must lie within ``LSE_BF16_TOL``; the bf16 backward kernel at
    that shape (row 6-bwd) and at DeepSeek-V2-Lite's MLA widths (row
    6m-bwd: 16 heads, D 192, Dv 128), dq, dk, dv within
    ``TRAIN_GRAD_TOL_BF16`` of the plain version's largest magnitude, with
    SDPA's bf16 backward's error against the same plain version printed
    beside it for scale; and ``moe_combine_weight_grad`` on a bf16 buffer
    and dy at Phi-3.5-MoE's training shape (within ``WGRAD_TOL``).  The
    backward's bound counts five products at the bf16 rate, as row 6-bwd
    is defined; the library call is SDPA's bf16 forward + backward minus
    its forward, K/V repeated to the query heads."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert
    from repro_torch.roofline import hw

    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    rows = []
    B, S = PREFILL_BATCH, PREFILL_LEN
    for at, H, KH, Dh, Dv in ((TRAIN_AT_BF16, 32, 8, 128, 128),
                              (TRAIN_AT_MLA, 16, 16, 192, 128)):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, S, H, Dh), (B, S, KH, Dh),
                                          (B, S, KH, Dv), (B, S, H, Dv)))
        scale = Dh ** -0.5
        pairs = B * H * S * (S + 1) // 2
        shape = (f"B={B}, S={S}, H={H}, KH={KH}, D={Dh}, Dv={Dv}, bfloat16, "
                 f"causal")
        G = H // KH
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        kr, vr = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
        leaves = [t.detach().requires_grad_(True) for t in (qt, kr, vr)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                  scale=scale)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), leaves, dot)

        def fwd():
            return FK.flash_attention_fwd(q, k, v, causal=True, scale=scale,
                                          return_lse=True)

        out, lse = fwd()
        sdpa_fwd_ms = time_ms(sdpa_fwd, 5)
        if at == TRAIN_AT_BF16:  # row 6-lse
            plain_out = FK.flash_attention_fwd(q, k, v, causal=True,
                                               scale=scale)
            if not torch.equal(out, plain_out):
                fail("flash_attention_lse's output differs from the serving "
                     "instantiation's")
            r_out, r_lse = FR.flash_attention_ref(q, k, v, causal=True,
                                                  scale=scale,
                                                  return_lse=True)
            err_o = attn_err(out, r_out, f"with its logsumexp, {shape}")
            err_l = float((lse - r_lse).abs().max())
            print(f"flash_attention_lse check {shape}: output bit-equal to "
                  f"the serving instantiation's, logsumexp max abs err "
                  f"{err_l:.3g} (tol {LSE_BF16_TOL})", flush=True)
            if not err_l <= LSE_BF16_TOL:
                fail(f"flash_attention_lse's logsumexp differs from its "
                     f"plain version by {err_l}")
            del r_out, r_lse, plain_out
            t_b, by = bound(2 * (q.numel() + k.numel() + v.numel()
                                 + out.numel()) + 4 * lse.numel(),
                            2 * (2 * Dh) * pairs, hw.PEAK_FLOPS_BF16)
            rows.append({
                "name": FK.LSE_KERNEL, "at": at, "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
                "max_abs_err": max(err_o, err_l), "ms": time_ms(fwd, 10),
                "plain_ms": time_ms(lambda: FR.flash_attention_ref(
                    q, k, v, causal=True, scale=scale, return_lse=True), 3),
                "bound_ms": t_b, "bound_by": by, "library_ms": sdpa_fwd_ms,
                "serving_ms": time_ms(lambda: FK.flash_attention_fwd(
                    q, k, v, causal=True, scale=scale), 10),
                "shape": f"{shape}, with the row logsumexp (SDPA forward "
                         f"with grad, K/V repeated to {H} heads)"})

        def bwd():
            return FK.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                          scale=scale)

        got = bwd()
        want = FR.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                                          scale=scale)
        errs = [float((a.float() - b).abs().max()) for a, b in zip(got, want)]
        worst = max(e / float(b.abs().max()) for e, b in zip(errs, want))
        if not all(torch.equal(a, b) for a, b in zip(got, bwd())):
            fail(f"{FK.BWD_BF16_KERNEL} gives other bits on a second call")
        del got
        sq, sk, sv = sdpa_fwd_bwd()
        sdpa = (sq.transpose(1, 2), sk.unflatten(1, (KH, G)).sum(2)
                .transpose(1, 2), sv.unflatten(1, (KH, G)).sum(2)
                .transpose(1, 2))
        sdpa_worst = max(float((a.float() - b).abs().max()
                               / b.abs().max()) for a, b in zip(sdpa, want))
        del sq, sk, sv, sdpa
        print(f"{FK.BWD_BF16_KERNEL} check {shape}: max abs err dq/dk/dv "
              f"{[f'{e:.3g}' for e in errs]}, worst over the largest |plain| "
              f"{worst:.3g} (tol {TRAIN_GRAD_TOL_BF16:.3g}); SDPA's bf16 "
              f"backward against the same plain version {sdpa_worst:.3g}; "
              f"bit-equal on a second call", flush=True)
        if not worst <= TRAIN_GRAD_TOL_BF16:
            fail(f"{FK.BWD_BF16_KERNEL} disagrees with its plain version: "
                 f"{worst} of the largest magnitude ({shape})")
        del want
        t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                             + 2 * out.numel()) + 4 * lse.numel(),
                        2 * (3 * Dh + 2 * Dv) * pairs, hw.PEAK_FLOPS_BF16)
        plain_ms = time_ms(lambda: FR.flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal=True, scale=scale), 3)
        device_ms, passes = _bwd_passes(
            bwd, FK.BWD_BF16_KERNEL,
            ("delta_bf16_kernel", "dkdv_bf16_kernel", "dq_bf16_kernel"))
        rows.append({
            "name": FK.BWD_BF16_KERNEL, "at": at, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
            "max_abs_err": max(errs), "ms": time_ms(bwd, 10),
            "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "library_ms": time_ms(sdpa_fwd_bwd, 5) - sdpa_fwd_ms,
            "device_ms": device_ms, "pass_device_ms": passes,
            "err_of_largest": worst, "sdpa_err_of_largest": sdpa_worst,
            "shape": f"{shape}; library: SDPA bf16 forward + backward minus "
                     f"its forward, K/V repeated to {H} heads"})
        del q, k, v, do, out, lse, qt, kt, vt, dot, kr, vr, leaves

    cfg = get_config(LM_ARCH)
    T, d, E = PREFILL_BATCH * PREFILL_LEN, cfg.d_model, cfg.num_experts
    kk = cfg.experts_per_token
    C = capacity_per_expert(T, E, kk, cfg.capacity_factor)
    x = torch.randn((T, d), generator=gen, device=dev)
    router = torch.randn((d, E), generator=gen, device=dev) / d ** 0.5
    topk_idx, _, _ = _route({"router": router}, x, cfg)
    slot = MO.expert_slots(topk_idx, E)
    buf = torch.randn((E, C, d), generator=gen, device=dev).bfloat16()
    dy = torch.randn((T, d), generator=gen, device=dev).bfloat16()

    def wgrad():
        return MK.moe_combine_weight_grad(dy, buf, topk_idx, slot)

    got = wgrad()
    want = MR.combine_weight_grad_ref(dy, buf, topk_idx, slot)
    err = float((got - want).abs().max())
    print(f"moe_combine_weight_grad check on bf16 buf and dy: dtype "
          f"{got.dtype}, max abs err {err:.3g} (tol {WGRAD_TOL} of "
          f"{float(want.abs().max()):.3g})", flush=True)
    if got.dtype != torch.float32 or \
            not err <= WGRAD_TOL * float(want.abs().max()):
        fail(f"moe_combine_weight_grad on bf16 disagrees with its plain "
             f"version by {err} (largest |plain| {float(want.abs().max())})")
    keep = slot < C
    kept = int(keep.sum())
    flat = buf.reshape(E * C, d)
    rows_k = torch.where(keep, topk_idx * C + slot, 0).reshape(-1)

    def library():  # index_select · mul · sum, dropped slots zeroed
        g = torch.index_select(flat, 0, rows_k).view(T, kk, d)
        return (g.float() * dy.float()[:, None]).sum(-1) * keep

    t_b, by = bound(2 * (T * d + kept * d) + 4 * T * kk, 2 * kept * d)
    rows.append({"name": "moe_combine_weight_grad", "at": TRAIN_AT_BF16,
                 "route": "cuda",
                 "source": "src/repro_torch/csrc/moe_dispatch.cu",
                 "replaces": "src/repro/kernels/moe_dispatch/kernel.py:98",
                 "max_abs_err": err, "ms": time_ms(wgrad),
                 "plain_ms": time_ms(lambda: MR.combine_weight_grad_ref(
                     dy, buf, topk_idx, slot)),
                 "bound_ms": t_b, "bound_by": by,
                 "library_ms": time_ms(library),
                 "shape": f"T={T}, k={kk}, d={d}, E={E}, C={C}, bfloat16 buf "
                          f"and dy, float32 weights, {kept} routed rows"})
    return rows


def moe_decode_calls(cfg, router, randn, combine_case):
    """Phi-3.5-MoE's MoE kernels at the decode shape: one token per
    request of a batch of ``SERVE_BATCH``, as every decode step of phase 6
    dispatches them (most of the launches).  Returns the calls to time
    (kernel, library, bound) by name, what each routes, and the combine's
    max abs error."""
    import torch

    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert

    T4, d, E = SERVE_BATCH, cfg.d_model, cfg.num_experts
    C4 = capacity_per_expert(T4, E, cfg.experts_per_token,
                             cfg.capacity_factor)
    x4 = randn(T4, d)
    idx4, w4, _ = _route({"router": router}, x4, cfg)
    slot4 = MO.expert_slots(idx4, E)
    ev4, sv4 = idx4[:, 0], slot4[:, 0]
    e4 = ev4.to(torch.int32).contiguous()
    s4 = sv4.contiguous()
    buf4 = MK.moe_dispatch(x4, ev4, sv4, E, C4)
    if not torch.equal(buf4, MR.dispatch_ref(x4, e4, s4, E, C4)):
        fail("moe_dispatch disagrees with its plain version at decode shape")
    kept4 = int((s4 < C4).sum())
    rows4 = torch.where(s4 < C4, e4.long() * C4 + s4.long(), E * C4)
    lib4 = torch.zeros((E * C4 + 1, d), dtype=x4.dtype, device=x4.device)
    call4, _, lib_combine4, bound4, kept4c, err4 = combine_case(x4, idx4, w4,
                                                                E, C4)
    where = f"T={T4}, d={d}, E={E}, C={C4}, bf16"
    kept_at_decode = {"moe_dispatch": f"{where}, slot 0, {kept4} routed rows",
                      "moe_combine": f"{where}, both slots, {kept4c} routed "
                                     f"rows"}
    decode = {
        "moe_dispatch": (
            lambda: MK.moe_dispatch(x4, ev4, sv4, E, C4),
            lambda: lib4.zero_().index_put_((rows4,), x4, accumulate=True),
            bound(kept4 * d * 2 + T4 * 8 + E * C4 * d * 2, kept4 * d)),
        "moe_combine": (call4, lib_combine4, bound4),
    }
    return decode, kept_at_decode, err4


def dispatch_calls(dev, seed: int) -> dict:
    """``--only moe-dispatch``: the layer body's dispatch call,
    ``ops.dispatch(x, topk_idx[:, 0], slot[:, 0], E, C)`` on a real top-2
    routing, at phase 6's decode shape (4 tokens, C 16) and prefill shape
    (8192 tokens, C 1280), d 4096, E 16, bf16: the device time and kernels
    a call (profiler), the host time a call, and CUDA events around one
    call; exact against the plain version.  It calls only what every slice
    of the port offers, so that two checkouts can be timed in turns."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert

    cfg = get_config(LM_ARCH)
    d, E, k = cfg.d_model, cfg.num_experts, cfg.experts_per_token
    gen = torch.Generator(device=dev).manual_seed(seed)
    router = torch.randn((d, E), generator=gen, device=dev) / d ** 0.5
    out = {}
    for shape, T, calls in (("decode", SERVE_BATCH, DECODE_CALLS),
                            ("prefill", PREFILL_BATCH * PREFILL_LEN, 20)):
        C = capacity_per_expert(T, E, k, cfg.capacity_factor)
        x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
        topk_idx, _, _ = _route({"router": router}, x, cfg)
        slot = MO.expert_slots(topk_idx, E)

        def call():
            return MO.dispatch(x, topk_idx[:, 0], slot[:, 0], E, C)

        if not torch.equal(call(), MR.dispatch_ref(x, topk_idx[:, 0],
                                                   slot[:, 0], E, C)):
            fail(f"moe_dispatch at the {shape} shape is not exact")
        host_ms = host_ms_per_call(call, calls)  # before any profiling
        dev_ms, n_kernels = device_ms_per_call(call, "moe_dispatch", calls)
        out[shape] = {"T": T, "C": C, "device_ms": dev_ms,
                      "kernels_per_call": n_kernels, "host_ms": host_ms,
                      "events_ms": time_ms(call)}
    return out


def moe_layer_calls(dev, seed: int) -> dict:
    """``--only moe-layer``: the MoE layer body with an identity FFN,
    ``ops.moe_dispatch(params, x, topk_idx, topk_w, cfg, C, lambda p, b, c:
    b)`` on a real top-2 routing at phase 6's decode shape (4 tokens, C 16)
    and prefill shape (8192 tokens, C 1280), d 4096, E 16, bf16: the device
    time and kernels a call (profiler), the MoE kernels' launches a call,
    the host time a call, and CUDA events around one call; exact against
    the plain versions' composition (the layer body's loop of
    ``dispatch_ref``, ``combine_ref`` and adds).  It calls only what every
    slice of the port offers, so that two checkouts can be timed in
    turns."""
    import torch

    from repro_torch import device as D
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import ops as MO
    from repro_torch.kernels.moe_dispatch import ref as MR
    from repro_torch.models.moe import _route, capacity_per_expert

    cfg = get_config(LM_ARCH)
    d, E, k = cfg.d_model, cfg.num_experts, cfg.experts_per_token
    gen = torch.Generator(device=dev).manual_seed(seed)
    router = torch.randn((d, E), generator=gen, device=dev) / d ** 0.5
    out = {}
    for shape, T, calls in (("decode", SERVE_BATCH, DECODE_CALLS),
                            ("prefill", PREFILL_BATCH * PREFILL_LEN, 20)):
        C = capacity_per_expert(T, E, k, cfg.capacity_factor)
        x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
        topk_idx, topk_w, _ = _route({"router": router}, x, cfg)

        def call():
            return MO.moe_dispatch(None, x, topk_idx, topk_w, cfg, C,
                                   lambda p, b, c: b)

        slot = MO.expert_slots(topk_idx, E)
        buf = want = None
        for j in range(k):
            b = MR.dispatch_ref(x, topk_idx[:, j], slot[:, j], E, C)
            buf = b if buf is None else buf + b
        for j in range(k):
            c = MR.combine_ref(buf, topk_idx[:, j], slot[:, j], topk_w[:, j])
            want = c if want is None else want + c
        if not torch.equal(call(), want):
            fail(f"the MoE layer body at the {shape} shape is not exact")
        host_ms = host_ms_per_call(call, calls)  # before any profiling
        before = D.launch_counts()
        call()
        after = D.launch_counts()
        dev_ms, n_kernels = device_ms_per_call(call, None, calls)
        out[shape] = {"T": T, "C": C, "device_ms": dev_ms,
                      "kernels_per_call": n_kernels, "host_ms": host_ms,
                      "events_ms": time_ms(call),
                      "launches_per_call": {
                          n: after[n] - before[n]
                          for n in ("moe_dispatch", "moe_combine")}}
    return out


def query_turns(names, orders, lineitem, want, kernels) -> dict:
    """Queries ``names`` through ``Session(policy="tensor")``: each checked
    against the oracle, then the warm p50 of ``WARM_RUNS`` and one traced
    warm run's wall and device time, and the device time of the kernels
    whose names hold one of ``kernels`` (``Memcpy`` for the copies)."""
    qs = queries(tensor_session(orders, lineitem))
    out = {}
    for name in names:
        q = qs[name]
        check_answer(name, q.collect(), want[name])
        _, warm = warm_runs(name, q, want[name])
        prof, wall_us = traced_run(q)
        rows, busy = device_rows(prof)
        out[name] = {"warm_p50_ms": statistics.median(warm) * 1e3,
                     "traced_wall_us": wall_us, "device_us": busy,
                     "device_events": sum(r[1] for r in rows)}
        for k in (*kernels, "Memcpy"):
            out[name][f"{k}_us"] = sum(us for us, _, key in rows if k in key)
    return out


def join_build_calls(dev, seed: int) -> dict:
    """``--only join-build``: ``kernel.join_table_build(bk_ord, brow, dpad)``
    at Q-a's build shape, as the main path hands it over and in the other
    cases of ``table_build_cases`` (CUDA events, each exact against the
    plain version), its device time and kernels a call (profiler); then
    Q-a and Q-b through ``Session(policy="tensor")``: warm p50 of
    ``WARM_RUNS`` (answers held against the oracle), and one traced warm
    run's device time and the build kernel's share of it.  It calls only
    what every slice of the port offers, so that two checkouts can be timed
    in turns."""
    from repro_torch.kernels.segment_join import kernel as K
    from repro_torch.kernels.segment_join import ref

    orders, lineitem = tpch(1.0, seed)
    want = oracle(orders, lineitem)
    j = join_inputs(orders, lineitem, dev)
    out = {"build_ms": table_build_cases(K, ref, j, dev)}
    out["build_device_ms"], out["build_kernels_per_call"] = \
        device_ms_per_call(lambda: K.join_table_build(
            j["bk_ord"], j["brow"], j["dpad"]), "join_table_build", 20)
    del j
    out.update(query_turns(("Q-a", "Q-b"), orders, lineitem, want,
                           ("join_table_build",)))
    return out


def join_probe_calls(dev, seed: int) -> dict:
    """``--only join-probe``: ``ops.radix_hash_probe`` at Q-a's shape (the
    codes ``join_inputs`` gives: 2,097,152 build rows, 8,388,608 probes)
    with the probe codes as they come and with their rows shuffled: CUDA
    events, device time and kernels a call (profiler), each call held
    against the plain scatter oracle on the card; the probe kernel alone
    on the radix-ordered codes; then Q-a and Q-b (warm p50, traced device
    time, the probe and radix kernels' share).  It calls only what every
    slice of the port offers, so that two checkouts can be timed in
    turns."""
    import torch

    from repro_torch.kernels.segment_join import kernel as K
    from repro_torch.kernels.segment_join import ops, ref

    orders, lineitem = tpch(1.0, seed)
    want = oracle(orders, lineitem)
    j = join_inputs(orders, lineitem, dev)
    bk, domain = j["bk0c"], j["domain"]
    gen = torch.Generator(device=dev).manual_seed(13)
    pk0c = j["pk0c"]
    codes = {"in_order": pk0c,
             "shuffled": pk0c[torch.randperm(pk0c.numel(), generator=gen,
                                             device=dev)].contiguous()}
    out = {}
    for what, pk in codes.items():
        got = ops.radix_hash_probe(bk, pk, domain)
        for g, w in zip(got, ref.radix_hash_probe_ref(bk, pk, domain)):
            if not torch.equal(g, w):
                fail(f"radix_hash_probe ({what}) disagrees with its plain "
                     f"version")
        dev_ms, n_kernels = device_ms_per_call(
            lambda: ops.radix_hash_probe(bk, pk, domain), None, 20)
        out[what] = {"ms": time_ms(lambda: ops.radix_hash_probe(bk, pk,
                                                                domain)),
                     "device_ms": dev_ms, "kernels_per_call": n_kernels}
        print(f"radix_hash_probe {what}: {out[what]['ms']:.4f} ms, device "
              f"{dev_ms:.4f} ms in {n_kernels} kernels a call", flush=True)
    cnt_t, inv_t = K.join_table_build(j["bk_ord"], j["brow"], j["dpad"])
    pdest, _ = ops.radix_partition(j["ids_p"], j["nblocks"])
    pk_ord, _ = ops._order(pk0c, pdest)
    out["probe_kernel_radix_order_ms"] = time_ms(
        lambda: K.join_table_probe(pk_ord, cnt_t, inv_t))
    out["probe_kernel_radix_order_device_ms"], _ = device_ms_per_call(
        lambda: K.join_table_probe(pk_ord, cnt_t, inv_t), None, 20)
    del j, cnt_t, inv_t, pdest, pk_ord, codes
    out.update(query_turns(("Q-a", "Q-b"), orders, lineitem, want,
                           ("join_table_probe", "radix")))
    return out


def segment_sum_calls(dev, seed: int) -> dict:
    """``--only segment-sum``: the cases of ``segment_sum_cases`` at Q-c's
    shape (the route of each too, where the checkout offers
    ``kernel.segment_sum_route``), where the device time of Q-c's own sum
    goes, then Q-c and Q-e (warm p50, traced device time, the segment
    sum's share).  It calls only what every slice of the port offers, so
    that two checkouts can be timed in turns."""
    from repro_torch.kernels.segment_join import kernel as K
    from repro_torch.kernels.segment_join import ref

    orders, lineitem = tpch(1.0, seed)
    want = oracle(orders, lineitem)
    cases, err = segment_sum_cases(K, ref, lineitem, dev,
                                   hasattr(K, "segment_sum_route"))
    out = {"cases": cases, "max_abs_err": err}
    # where the device time of Q-c's own sum goes, kernel by kernel
    import torch
    from torch.profiler import ProfilerActivity, profile

    cents = torch.from_numpy(lineitem["l_extendedprice"]).to(dev).double()
    n = cents.numel()
    seg = torch.arange(n, device=dev, dtype=torch.int32) // 600
    call = segment_sum_call(K, seg, cents, n)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, _ = device_rows(prof)
    out["cents_runs_kernels_us"] = {key[:60]: us / 20 for us, _, key in rows}
    print_profile("segment_sum, integer cents in runs of 600 rows, 20 calls",
                  prof, wall_us)
    out.update(query_turns(("Q-c", "Q-e"), orders, lineitem, want,
                           ("segment_sum", "radix")))
    return out


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def tensor_session(orders, lineitem):
    """A card Session over the two tables with the tensor policy, as phase
    3, its traces and ``--only join-build`` drive the queries."""
    from repro_torch.core import Session

    sess = Session(work_mem=1 << 20, policy="tensor", device="cuda")
    sess.register("orders", orders)
    sess.register("lineitem", lineitem)
    return sess


def warm_runs(name, q, want, runs: int = WARM_RUNS):
    """``runs`` warm runs of query ``q``, each answer held against the
    oracle's ``want``: their results and wall times in s."""
    results, secs = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = q.collect()
        secs.append(time.perf_counter() - t0)
        check_answer(name, res, want)
        results.append(res)
    return results, secs


def traced_run(q):
    """One warm run of query ``q`` under torch.profiler: the profile and
    the run's wall time in us, up to the card's last kernel.  Runs are
    traced until two hold as many device events (a trace that lost
    events, wholly or in part, agrees with no other); the second of them
    is returned.  Fails after ``TRACE_TRIES`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = set()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            q.collect()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        n = len(device_events(prof))
        if n and n in seen:
            return prof, wall_us
        if seen:
            print(f"query trace: {n} device events against {sorted(seen)} "
                  f"before, traced again", flush=True)
        seen.add(n)
    fail(f"{TRACE_TRIES} traces of one query, no two with the same count "
         f"of device events ({sorted(seen)})")


def main_path(orders, lineitem, want):
    import torch

    from repro_torch import device as D

    qs = queries(tensor_session(orders, lineitem))
    expect = {
        "Q-a": ("radix_rank", "join_table_build", "join_table_probe"),
        "Q-b": ("radix_rank", "join_table_build", "join_table_probe"),
        "Q-c": ("segment_sum",),
        "Q-d": ("radix_sort_pass",),
        "Q-e": ("segment_sum",),
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
        check_no_fallback(name, res.metrics)
        results, warm = warm_runs(name, q, want[name])
        res = results[-1]
        syncs = [r.total_host_syncs for r in results]
        h2d = [r.total_h2d_bytes for r in results]
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
        if name == "Q-d":
            if "sort" not in ops:
                fail(f"Q-d did not run the per-operator device sort: {ops}")
            if set(syncs) != {1}:
                fail(f"Q-d: warm host_syncs {syncs} (the sort must not wait "
                     f"for the device)")
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
    names = list(SERVED)
    D.reset_launch_counts()
    rep = server.serve([qs[k] for k in names], concurrency=8,
                       queries_per_worker=4, warmup=1)
    launches = D.launch_counts()
    check_served(f"closed loop ({policy})", rep, names, want)
    if policy == "tensor":
        idle = [k for k in D.RELATIONAL_KERNELS if launches[k] <= 0]
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
    names = list(SERVED)
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


def profile_queries(orders, lineitem, want) -> None:
    """Where a warm query's time goes: torch.profiler over one warm run of
    each query (after two checked against the oracle), the top kernels by
    device time, and the device's busy share of the query's wall time."""
    for name, q in queries(tensor_session(orders, lineitem)).items():
        warm_runs(name, q, want[name], 2)
        print_profile(name, *traced_run(q))


def device_rows(prof):
    """A trace's kernels as (device us, count, name), largest first, and
    their total device time in us."""
    import torch

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
    return rows, sum(r[0] for r in rows)


def print_profile(label: str, prof, wall_us: float, top: int = 12) -> None:
    """The device's busy share of a traced window's wall time and its
    kernels by device time."""
    rows, busy = device_rows(prof)
    print(f"profile {label}: wall {wall_us:.0f} us, device busy "
          f"{busy:.0f} us ({100 * busy / wall_us:.1f}%), idle "
          f"{100 - 100 * busy / wall_us:.1f}%, "
          f"{sum(r[1] for r in rows)} device events", flush=True)
    for dev_us, count, key in rows[:top]:
        print(f"  {dev_us:10.1f} us  x{count:<5d} {key[:90]}", flush=True)


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


# ---------------------------------------------------------------------------
# Phase 4b: the memory-pressure path on the card
# ---------------------------------------------------------------------------

MB = 1 << 20
PRESSURE_WORK_MEM = 1 * MB   # the paper's headline work_mem
HEADLINE_ROWS = 1_000_000    # the paper's headline N
HEADLINE_RUNS = 5            # after one warm-up; p50 and max over these
STALE = 0.02                 # fig14's mis-calibration: linear 50x too cheap
JOIN_KERNELS = ("radix_rank", "join_table_build", "join_table_probe")


def headline_table(seed: int) -> dict:
    """``benchmarks/common.py::sort_table(1_000_000, 4)`` with numpy from
    ``seed``: four keys over domains 64, 2^16, 2^30 and 2^40, two payload
    columns."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cols = {f"k{i}": rng.integers(0, d, HEADLINE_ROWS).astype(np.int64)
            for i, d in enumerate((64, 1 << 16, 1 << 30, 1 << 40))}
    for c in ("p0", "p1"):
        cols[c] = rng.integers(0, 1 << 40, HEADLINE_ROWS).astype(np.int64)
    return cols


def guard_star(n: int, seed: int = 14):
    """``tests/test_adaptive_guards.py::star_tables``: a build side whose
    keys are a permutation, a probe side drawn from them; and the numpy
    answer of ``sum(b_v)`` over their join."""
    import numpy as np

    rng = np.random.default_rng(seed)
    build = {"k": rng.permutation(n).astype(np.int64),
             "v": rng.integers(0, 1 << 30, n).astype(np.int64)}
    probe = {"k": rng.integers(0, n, n).astype(np.int64),
             "w": rng.integers(0, 1 << 30, n).astype(np.int64)}
    v_at = np.empty(n, np.int64)
    v_at[build["k"]] = build["v"]
    return build, probe, int(v_at[probe["k"]].sum())


def stale_session(work_mem: int, **kw):
    """An ``auto`` card session whose selector prices the linear path 50x
    too cheap (fig14's stale constants): it commits to the spill cliff."""
    from repro_torch.core import Session

    sess = Session(work_mem=work_mem, policy="auto", device="cuda", **kw)
    sess.selector.model.c.linear_row_cost *= STALE
    sess.selector.model.c.io_byte_cost *= STALE
    return sess


def spill_books(label: str, metrics) -> tuple:
    """Spill bytes written and blocks over a query's operators; fails
    unless every byte written was freed."""
    written = sum(m.spill.bytes_written for m in metrics)
    freed = sum(m.spill.bytes_freed for m in metrics)
    if written != freed:
        fail(f"{label}: spilled {written} B but freed {freed} B")
    return written, sum(m.spill.blocks for m in metrics)


def check_no_fallback(label: str, metrics) -> None:
    """Only an injected device fault may move an operator to the linear
    path (a ``device-fallback`` reason); a real kernel or CUDA error
    propagates."""
    bad = [m.op for m in metrics
           if m.decision_reason.startswith("device-fallback")]
    if bad:
        fail(f"{label}: operators {bad} fell back from the device")


def pressure_headline(seed: int) -> dict:
    """Check 1: the paper's headline sort at 1 MB of work_mem, the linear
    external merge sort against the tensor path's sort on the card, each
    one warm-up and ``HEADLINE_RUNS`` runs timed on the host clock (the
    tensor run's upload and fetch included); rows equal each other and a
    numpy lexsort, ``radix_sort_pass`` launched by the tensor runs."""
    import numpy as np

    from repro_torch import device as D
    from repro_torch.core import Relation, sort_linear, tensor_sort

    cols = headline_table(seed)
    rel = Relation(cols)
    keys = ["k0", "k1", "k2", "k3"]
    order = np.lexsort([cols[k] for k in reversed(keys)])
    out = {}
    for path in ("linear", "tensor"):
        before = D.launch_counts()["radix_sort_pass"]
        secs, res = [], None
        for i in range(1 + HEADLINE_RUNS):
            t0 = time.perf_counter()
            if path == "linear":
                res, m = sort_linear(rel, keys, PRESSURE_WORK_MEM)
            else:
                res, m = tensor_sort(rel, keys, device="cuda")
            if i:
                secs.append(time.perf_counter() - t0)
        for k, v in cols.items():
            if not np.array_equal(res[k], v[order]):
                fail(f"headline ({path}): column {k} is not the sorted rows")
        launches = D.launch_counts()["radix_sort_pass"] - before
        if path == "tensor" and launches <= 0:
            fail("headline (tensor): radix_sort_pass was not launched")
        out[path] = {"p50_s": statistics.median(secs), "max_s": max(secs),
                     "runs_s": secs, "spilled_mb": m.spill.temp_mb,
                     "blocks": m.spill.blocks, "op_wall_s": m.wall_s,
                     "radix_sort_pass_launches": launches}
    return out


def pressure_sf1(orders, lineitem, want) -> dict:
    """Check 2: Q-a's join core at SF1 (lineitem ⋈ orders →
    sum(l_extendedprice), 6,001,215 x 1,500,000 rows) at 1 MB of
    work_mem: linear to flat disk, linear through the default tiers, and
    the stale ``auto`` session with guards off and on.  Each answer is
    the oracle's and every spilled byte is freed."""
    from repro_torch.core import Session, TierConfig

    modes = {"linear": lambda: Session(work_mem=PRESSURE_WORK_MEM,
                                       policy="linear", device="cuda"),
             "linear_tiered": lambda: Session(
                 work_mem=PRESSURE_WORK_MEM, policy="linear", device="cuda",
                 tiers=TierConfig()),
             "stale_auto_guards_off": lambda: stale_session(
                 PRESSURE_WORK_MEM, guards=False),
             "stale_auto_guards_on": lambda: stale_session(
                 PRESSURE_WORK_MEM, guards=True)}
    out = {}
    for mode, make in modes.items():
        sess = make()
        sess.register("orders", orders)
        sess.register("lineitem", lineitem)
        q = (sess.table("lineitem").join("orders", on="orderkey")
             .aggregate("l_extendedprice", "sum"))
        t0 = time.perf_counter()
        res = q.collect()
        wall = time.perf_counter() - t0
        label = f"SF1 join core ({mode})"
        if res.scalar != float(want["Q-a join"]):
            fail(f"{label}: {res.scalar!r} != oracle {want['Q-a join']}")
        check_no_fallback(label, res.metrics)
        written, blocks = spill_books(label, res.metrics)
        books = None
        if sess.tier_ledger is not None:
            sess.tier_ledger.verify_balanced()
            snap = sess.tier_ledger.snapshot()
            books = {t: {k: snap[t][k] for k in ("bytes_written",
                                                 "bytes_read", "bytes_freed")}
                     for t in ("t0", "t1", "t2")}
        out[mode] = {"wall_s": wall, "spilled_mb": written / 1e6,
                     "blocks": blocks, "tiers": books,
                     "ops": [f"{m.op}:{m.path}" for m in res.metrics],
                     "switches": sum(m.switched for m in res.metrics)}
    return out


def pressure_switches() -> dict:
    """Check 3: stale ``auto`` sessions on the card whose guards abandon
    the spilling linear operator for the tensor path: the star join
    (120,000 rows, 256 KB, flat disk) and the sort (200,000 rows, 128 KB),
    each with exactly one switched operator, the linear run's answer at
    64 MB, and the takeover's kernels launched."""
    import numpy as np

    from repro_torch import device as D
    from repro_torch.core import Session

    def one_switch(label, res):
        check_no_fallback(label, res.metrics)
        sw = [m for m in res.metrics if m.switched]
        if len(sw) != 1 or sw[0].pre_switch_path != "linear" \
                or sw[0].path != "tensor":
            fail(f"{label}: switched ops "
                 f"{[(m.op, m.pre_switch_path, m.path) for m in sw]} of "
                 f"{[m.op for m in res.metrics]}, want one linear -> tensor")
        spill_books(label, res.metrics)
        return {"op": sw[0].op, "wall_s": sw[0].wall_s,
                "pre_switch_wall_s": sw[0].pre_switch_wall_s,
                "reused_spill_bytes": sw[0].reused_spill_bytes,
                "spilled_mb": sw[0].spill.temp_mb,
                "reason": sw[0].decision_reason}

    out = {}
    build, probe, want = guard_star(120_000)
    for label, sess in (("linear, 64 MB", Session(
            work_mem=64 * MB, policy="linear", device="cuda")),
                        ("stale auto", stale_session(256 * 1024))):
        sess.register("b", build).register("p", probe)
        before = D.launch_counts()
        res = (sess.table("p").join("b", on="k")
               .aggregate("b_v", "sum")).collect()
        after = D.launch_counts()
        if res.scalar != float(want):
            fail(f"star join ({label}): {res.scalar!r} != {want}")
    out["join"] = one_switch("star join switch", res)
    delta = {k: after[k] - before[k] for k in JOIN_KERNELS}
    if min(delta.values()) <= 0:
        fail(f"star join switch: the takeover launched {delta}")
    out["join"]["launches"] = delta

    rng = np.random.default_rng(3)
    n = 200_000
    rel = {"k": rng.integers(0, n, n).astype(np.int64),
           "w": rng.integers(0, 1 << 30, n).astype(np.int64)}
    order = np.lexsort((rel["w"], rel["k"]))
    for label, sess in (("linear, 64 MB", Session(
            work_mem=64 * MB, policy="linear", device="cuda")),
                        ("stale auto", stale_session(128 * 1024))):
        sess.register("t", rel)
        before = D.launch_counts()["radix_sort_pass"]
        res = sess.table("t").sort("k", "w").collect()
        launches = D.launch_counts()["radix_sort_pass"] - before
        for k, v in rel.items():
            if not np.array_equal(res.relation[k], v[order]):
                fail(f"sort ({label}): column {k} differs")
    out["sort"] = one_switch("sort switch", res)
    if launches <= 0:
        fail("sort switch: the takeover did not launch radix_sort_pass")
    out["sort"]["launches"] = {"radix_sort_pass": launches}
    return out


def pressure_chaos() -> dict:
    """Check 4: ``test_chaos_switch_hammer``'s server on the card (8
    workers x 4, 24 MB, 512 KB of work_mem, free remote tier, injected
    spill, grant and slow-device faults, stale constants, eager
    hysteresis): every query served or failed, every served answer the
    oracle's, never over budget, balanced tier books, faults injected.
    Switches are printed, not required (they depend on the race)."""
    from repro_torch.core import FaultInjector, QueryServer, TierConfig

    build, probe, want = guard_star(60_000)
    srv = QueryServer(
        {"b": build, "p": probe}, total_mem=24 * MB, work_mem=512 * 1024,
        min_grant=256 * 1024, device="cuda",
        tiers=TierConfig(t1_latency_s=0.0, t1_gbps=1000.0),
        faults=FaultInjector(seed=7, spill_io_p=0.01, device_slow_p=0.05,
                             device_slow_s=0.002, grant_timeout_p=0.01,
                             spill_read_p=0.01))
    c = srv.session.selector.model.c
    c.linear_row_cost *= STALE
    c.io_byte_cost *= STALE
    c.guard_hysteresis = 0.5
    q = srv.session.table("p").join("b", on="k").aggregate("b_v", "sum")
    t0 = time.perf_counter()
    rep = srv.serve([q], concurrency=8, queries_per_worker=4, warmup=1)
    wall = time.perf_counter() - t0
    counts = rep.counts
    if counts["served"] + counts["failed"] != 32 or counts["served"] <= 0:
        fail(f"chaos: {counts}")
    for sq in rep.queries:
        if sq.scalar != float(want):
            fail(f"chaos: a served answer {sq.scalar!r} != {want}")
    if rep.governor.over_budget_events or srv.governor.held_bytes:
        fail(f"chaos: {rep.governor.over_budget_events} over-budget events, "
             f"{srv.governor.held_bytes} bytes held")
    srv.session.tier_ledger.verify_balanced()
    faults = srv.faults.counts()
    if sum(faults.values()) <= 0:
        fail("chaos: no fault was injected")
    if faults["device_fail"]:
        fail("chaos: a device fault was injected (none is configured)")
    return {"counts": counts, "wall_s": wall, "faults": faults,
            "switches": srv.broker.stats().switches,
            "switched_queries": sum(sq.switched for sq in rep.queries),
            "failed": sorted({f.error for f in rep.failed}),
            "p50_s": rep.latency.p50 if rep.queries else None}


def pressure_device_faults(orders, lineitem, want) -> dict:
    """Check 5: SF1 Q-a through a tensor session whose broker's injector
    fails every device lease: the executor's retries count the failures,
    after ``RetryPolicy.device_fallback_after`` of them the query runs
    linear with ``device-fallback`` reasons, and the answer is the
    oracle's.  (A fresh fused program takes no lease, so the query runs
    twice.)"""
    from repro_torch.core import (FaultInjector, ResourceBroker, RetryPolicy,
                                  Session)

    inj = FaultInjector(seed=0, device_fail_p=1.0)
    sess = Session(work_mem=PRESSURE_WORK_MEM, policy="tensor",
                   device="cuda", broker=ResourceBroker(None, faults=inj))
    sess.register("orders", orders)
    sess.register("lineitem", lineitem)
    q = queries(sess)["Q-a"]
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = q.collect()
        secs.append(time.perf_counter() - t0)
        check_answer("Q-a", res, want["Q-a"])
    fails = inj.counts()["device_fail"]
    if fails < RetryPolicy().device_fallback_after:
        fail(f"device faults: {fails} injected")
    reasons = [m.decision_reason for m in res.metrics]
    if (not res.metrics or any(m.path != "linear" for m in res.metrics)
            or not all(r.startswith("device-fallback") for r in reasons)):
        fail(f"device faults: ops {[(m.op, m.path) for m in res.metrics]}, "
             f"reasons {reasons}")
    return {"device_fail": fails, "wall_s": secs,
            "ops": [f"{m.op}:{m.path}" for m in res.metrics],
            "spilled_mb": sum(m.spill.temp_mb for m in res.metrics)}


def pressure_phase(orders, lineitem, want, seed: int) -> dict:
    """Phase 4b's five checks, each printed as it ends."""
    t_all = time.perf_counter()
    out = {"headline": pressure_headline(seed)}
    for path, r in out["headline"].items():
        print(f"headline sort ({path}, {HEADLINE_ROWS} rows x 4 keys, "
              f"{PRESSURE_WORK_MEM} B work_mem): p50 {r['p50_s']:.4f} s, max "
              f"{r['max_s']:.4f} s over {HEADLINE_RUNS}, spilled "
              f"{r['spilled_mb']:.2f} MB in {r['blocks']} blocks, "
              f"radix_sort_pass launches {r['radix_sort_pass_launches']}",
              flush=True)
    out["sf1"] = pressure_sf1(orders, lineitem, want)
    for mode, r in out["sf1"].items():
        print(f"SF1 join core ({mode}): {r['wall_s']:.3f} s, spilled "
              f"{r['spilled_mb']:.2f} MB in {r['blocks']} blocks, switches "
              f"{r['switches']}, ops {r['ops']}, tiers {r['tiers']}",
              flush=True)
    out["switches"] = pressure_switches()
    for what, r in out["switches"].items():
        print(f"{what} switch onto the card: {r['op']} after "
              f"{r['pre_switch_wall_s']:.4f} s linear, {r['wall_s']:.4f} s "
              f"in all, spilled {r['spilled_mb']:.3f} MB, reused "
              f"{r['reused_spill_bytes']} B, launches {r['launches']}",
              flush=True)
    out["chaos"] = pressure_chaos()
    r = out["chaos"]
    print(f"chaos (8 workers x 4): {r['counts']}, faults {r['faults']}, "
          f"switches {r['switches']}, failed as {r['failed']}, "
          f"{r['wall_s']:.2f} s", flush=True)
    out["device_faults"] = pressure_device_faults(orders, lineitem, want)
    r = out["device_faults"]
    print(f"device faults: {r['device_fail']} injected, Q-a ran "
          f"{r['ops']} in {[round(s, 3) for s in r['wall_s']]} s",
          flush=True)
    out["wall_s"] = time.perf_counter() - t_all
    print(f"pressure phase: {out['wall_s']:.1f} s", flush=True)
    return out


def pressure_calls(dev, seed: int) -> dict:
    """``--only pressure``: phase 4b on fresh SF1 tables."""
    orders, lineitem = tpch(1.0, seed)
    return pressure_phase(orders, lineitem, oracle(orders, lineitem), seed)


# ---------------------------------------------------------------------------
# Phase 5b: the sharded fragment over eight logical lanes, placed on
# the cards present
# ---------------------------------------------------------------------------

FIG15_ROWS = 1_000_000       # benchmarks/figures.py fig15's full size
SHARDS = (1, 2, 4, 8)
SHARD_COLD, SHARD_WARM = 2, 7
LANES = 8


def fig15_fragment(seed: int):
    """fig15's fragment (``benchmarks/figures.py``): unique sparse build
    keys ``perm * 1_000_003 + 17``, probe keys drawn from them, filter
    ``w < 500``, ``sum(b_v)``; with its numpy oracle."""
    import numpy as np

    from repro_torch.core import FusedSpec, Relation, col

    rng = np.random.default_rng(seed)
    n = FIG15_ROWS
    bk = rng.permutation(n).astype(np.int64) * 1_000_003 + 17
    build = Relation({"k": bk,
                      "v": rng.integers(0, 1 << 30, n).astype(np.int64)})
    probe = Relation({"k": bk[rng.integers(0, n, n)],
                      "w": rng.integers(0, 1000, n).astype(np.int64)})
    spec = FusedSpec(join_key="k", filter_fn=col("w") < 500, sort_keys=(),
                     agg=("b_v", "sum"))
    order = np.argsort(bk)
    hit = order[np.searchsorted(bk[order], probe["k"])]
    oracle = float(build["v"][hit[probe["w"] < 500]].sum())
    return spec, build, probe, oracle


def check_lanes(label: str, lanes) -> None:
    """All ``LANES`` broker lanes exist and each has dispatched."""
    if len(lanes) < LANES:
        fail(f"{label}: {len(lanes)} broker lanes, expected {LANES}")
    idle = [i for i, lane in enumerate(lanes) if lane["dispatches"] <= 0]
    if idle:
        fail(f"{label}: lanes {idle} never dispatched")


def sharded_fig15(seed: int, profile: bool = False) -> dict:
    """(a) fig15's fragment through ``run_fused(device="cuda")`` at shards
    1, 2, 4 and 8 (placed on every card present), each with its own
    broker: ``SHARD_COLD`` cold runs, then ``SHARD_WARM`` warm ones, every
    scalar equal to the oracle; warm runs take 1 host sync on ``shards``
    lanes and, sharded, upload nothing.  With ``profile``, one more warm
    run at 1 and at 8 shards is traced."""

    import types

    from repro_torch.core import ResourceBroker, run_fused

    spec, build, probe, oracle = fig15_fragment(seed)
    out = {}
    for shards in SHARDS:
        broker = ResourceBroker()
        req = None if shards == 1 else shards
        cold, warm = [], []
        for i in range(SHARD_COLD + SHARD_WARM):
            scalar, m = run_fused(spec, build, probe, broker=broker,
                                  shards=req, device="cuda")
            if scalar != oracle:
                fail(f"fig15 at {shards} shards: {scalar!r} != oracle "
                     f"{oracle}")
            if i < SHARD_COLD:
                cold.append(m.wall_s)
                continue
            warm.append(m.wall_s)
            if (m.devices, m.host_syncs) != (shards, 1):
                fail(f"fig15 at {shards} shards: warm run on {m.devices} "
                     f"lanes with {m.host_syncs} host syncs")
            if shards > 1 and m.h2d_bytes:
                fail(f"fig15 at {shards} shards: a warm run uploaded "
                     f"{m.h2d_bytes} bytes")
        if shards == LANES:
            check_lanes("fig15", broker.stats().lanes)
        if profile and shards in (1, LANES):
            run = types.SimpleNamespace(collect=lambda: run_fused(
                spec, build, probe, broker=broker, shards=req,
                device="cuda"))
            print_profile(f"fig15 at {shards} shard(s)", *traced_run(run))
        out[shards] = {"cold_s": cold, "warm_p50_s": statistics.median(warm),
                       "warm_s": warm, "cards": placed_on("cuda", shards)}
    for shards in SHARDS:
        out[shards]["single_over_sharded"] = (out[1]["warm_p50_s"]
                                              / out[shards]["warm_p50_s"])
    return out


def print_fig15(shards: int, r: dict) -> None:
    print(f"fig15 fragment, {FIG15_ROWS} rows, {shards} shard(s) on "
          f"{len(r['cards'])} card(s): warm p50 {r['warm_p50_s'] * 1e3:.3f} "
          f"ms over {SHARD_WARM} (single-device p50 / this "
          f"{r['single_over_sharded']:.3f}), cold "
          f"{[round(c, 4) for c in r['cold_s']]} s", flush=True)


def partition_pass_s(orders, lineitem) -> float:
    """Seconds of the host partition pass over the columns Q-a reads, at
    ``LANES`` partitions: the build side sorted within its partitions, the
    probe side in row order (the cold sharded run pays this once)."""
    from repro_torch.core import Relation
    from repro_torch.core import partition as part

    t0 = time.perf_counter()
    part._build_partitions(Relation({k: orders[k] for k in
                                     ("orderkey", "o_orderdate")}),
                           "orderkey", LANES, True)
    part._build_partitions(Relation({k: lineitem[k] for k in
                                     ("orderkey", "l_shipdate",
                                      "l_extendedprice")}),
                           "orderkey", LANES, False)
    return time.perf_counter() - t0


def check_sharded_qa(res, want) -> None:
    d, m = res.decisions[-1], res.metrics[-1]
    if (d.path, d.shards, m.devices) != ("tensor", LANES, LANES):
        fail(f"sharded Q-a: path {d.path}, {d.shards} shards, {m.devices} "
             f"lanes ({d.reason})")
    check_answer("Q-a", res, want)


def placed_on(device, parts: int = LANES) -> list:
    """The cards ``parts`` partitions are placed on for ``device``."""
    from repro_torch.distributed.sharding import partition_placement

    return [str(d) for d in partition_placement(parts, device).devices]


def allocated_per_card() -> list:
    import torch

    return [torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())]


def sharded_qa(orders, lineitem, want, profile: bool = False,
               device="cuda", runs: int = WARM_RUNS) -> dict:
    """(b) Q-a at SF1 through ``Session(policy="auto", max_shards=8)``,
    its partitions placed on ``device``'s cards: the selector must price
    the sharded program lower (a forced ``tensor`` policy decides one
    device, as in the reference), every answer equals the oracle, warm
    runs take 1 host sync and upload nothing, and every card of the
    placement holds its block of the partitioned layout (none other holds
    any).  With ``profile``, one more warm run is traced."""
    from repro_torch.core import Relation, Session
    from repro_torch.core.partition import resident_partition_bytes

    sess = Session(work_mem=1 << 20, policy="auto", max_shards=LANES,
                   device=device)
    tables = {"orders": Relation.from_dict(orders),
              "lineitem": Relation.from_dict(lineitem)}
    for name, rel in tables.items():
        sess.register(name, rel)
    q = queries(sess)["Q-a"]
    t0 = time.perf_counter()
    res = q.collect()
    cold = time.perf_counter() - t0
    check_sharded_qa(res, want)
    reason = res.decisions[-1].reason
    results, warm = warm_runs("Q-a", q, want, runs)
    for r in results:
        check_sharded_qa(r, want)
        if (r.total_host_syncs, r.total_h2d_bytes) != (1, 0):
            fail(f"sharded Q-a: warm host_syncs {r.total_host_syncs}, h2d "
                 f"{r.total_h2d_bytes} B")
    if profile:
        print_profile("sharded Q-a", *traced_run(q))
    cards = placed_on(device)
    resident = {}
    for rel in tables.values():
        for card, nbytes in resident_partition_bytes(rel).items():
            resident[card] = resident.get(card, 0) + nbytes
    if sorted(resident) != sorted(cards) or min(resident.values()) <= 0:
        fail(f"sharded Q-a on {cards}: the partitioned layout is on "
             f"{resident}")
    return {"cold_s": cold, "cold_h2d_bytes": res.total_h2d_bytes,
            "warm_p50_s": statistics.median(warm), "warm_s": warm,
            "decision": reason, "cards": cards, "resident_bytes": resident,
            "allocated_bytes": allocated_per_card()}


def sharded_serving(orders, lineitem, want) -> dict:
    """(c) a governed ``QueryServer(max_shards=8)`` closed loop over Q-a:
    no failed or shed query, no over-budget event, every answer equal to
    the oracle and every lane dispatched."""
    from repro_torch.core import QueryServer

    server = QueryServer({"orders": orders, "lineitem": lineitem},
                         total_mem=SERVE_TOTAL_MEM, work_mem=SERVE_WORK_MEM,
                         max_shards=LANES, device="cuda")
    if len(server.broker.lanes) != LANES:
        fail(f"sharded server: {len(server.broker.lanes)} lanes at build")
    rep = server.serve([queries(server.session)["Q-a"]], concurrency=8,
                       queries_per_worker=4, warmup=1)
    check_served("sharded closed loop", rep, ["Q-a"], want)
    check_lanes("sharded closed loop", rep.broker.lanes)
    if server.governor.held_bytes != 0:
        fail(f"sharded closed loop: {server.governor.held_bytes} bytes "
             f"still held")
    return {"counts": rep.counts, "p50_s": rep.latency.p50,
            "p99_s": rep.latency.p99, "qps": rep.qps,
            "lane_dispatches": [lane["dispatches"]
                                for lane in rep.broker.lanes]}


def print_sharded_qa(r: dict, pass_s: float) -> None:
    print(f"sharded Q-a (SF1, {LANES} lanes on {len(r['cards'])} card(s) "
          f"{r['cards']}): cold {r['cold_s']:.4f} s ({r['cold_h2d_bytes']} "
          f"B uploaded; the host partition pass alone {pass_s:.4f} s, the "
          f"rest {r['cold_s'] - pass_s:.4f} s), warm p50 "
          f"{r['warm_p50_s'] * 1e3:.3f} ms over {len(r['warm_s'])} (min "
          f"{min(r['warm_s']) * 1e3:.3f}, max {max(r['warm_s']) * 1e3:.3f}); "
          f"partitioned "
          f"layout per card {r['resident_bytes']} B, allocated per card "
          f"{r['allocated_bytes']} B; {r['decision']}", flush=True)


def sharded_phase(orders, lineitem, want, seed: int,
                  profile: bool = False) -> dict:
    """Phase 5b: (a), (b) and (c), with the device memory they peak at;
    with ``profile``, a trace of one warm sharded Q-a."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"fig15": sharded_fig15(seed, profile)}
    for shards in SHARDS:
        r = out["fig15"][shards]
        print_fig15(shards, r)
    out["partition_pass_s"] = partition_pass_s(orders, lineitem)
    out["Q-a"] = sharded_qa(orders, lineitem, want["Q-a"], profile)
    print_sharded_qa(out["Q-a"], out["partition_pass_s"])
    out["serving"] = sharded_serving(orders, lineitem, want)
    r = out["serving"]
    print(f"sharded closed loop (Q-a, 8 workers x 4): {r['counts']}, p50 "
          f"{r['p50_s']:.4f} s, p99 {r['p99_s']:.4f} s, {r['qps']:.1f} q/s, "
          f"lane dispatches {r['lane_dispatches']}", flush=True)
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["allocated_at_start_bytes"] = base
    print(f"sharded phase peak device memory allocated: "
          f"{out['peak_allocated_bytes']} B ({base} B at its start)",
          flush=True)
    return out


def sharded_calls(dev, seed: int, profile: bool = False) -> dict:
    """``--only sharded``: phase 5b on fresh SF1 tables, after phase 3's
    single-device Q-a (warm p50, and with ``profile`` a trace) for
    comparison."""
    orders, lineitem = tpch(1.0, seed)
    want = oracle(orders, lineitem)
    q = queries(tensor_session(orders, lineitem))["Q-a"]
    check_answer("Q-a", q.collect(), want["Q-a"])
    _, warm = warm_runs("Q-a", q, want["Q-a"])
    single = statistics.median(warm)
    print(f"single-device Q-a: warm p50 {single * 1e3:.3f} ms", flush=True)
    if profile:
        print_profile("single-device Q-a", *traced_run(q))
    return {"single_device_qa_warm_p50_s": single,
            **sharded_phase(orders, lineitem, want, seed, profile)}


# ---------------------------------------------------------------------------
# Phase 6: LM serving (Phi-3.5-MoE at full width) on the card
# ---------------------------------------------------------------------------

def lm_phase(seed: int, profile: bool = False):
    """Phase 6: each model of ``LM_MODELS`` served in turn, the card's
    memory freed between them (``del`` and ``torch.cuda.empty_cache()``;
    fails if more than ``LM_LEFT_BYTES`` stay allocated).  Returns the
    reports and the launch counts of each model's run, by model."""
    import torch

    reports, launches = {}, {}
    for arch, layers in LM_MODELS:
        t0 = time.perf_counter()
        reports[arch], launches[arch] = lm_serving(arch, layers, seed,
                                                   profile)
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        print(f"{arch}: {time.perf_counter() - t0:.1f} s; "
              f"{left / 2**30:.3f} GiB left allocated after freeing it",
              flush=True)
        if left > LM_LEFT_BYTES:
            fail(f"{arch}'s run left {left} bytes allocated")
    return reports, launches


def lm_serving(arch: str, layers: int, seed: int, profile: bool = False):
    """Model ``arch`` at ``layers`` layers and full width in bf16, random
    weights made on the card from ``seed``: prefill 2 x 4096 tokens (cold,
    then warm), then serve 8 requests through the serve entry point's loop
    (BatchScheduler + generate), counters from 0 just before the prefill
    and read after the serving.  Its kernels must each launch: the radix
    sort (admission), bf16 flash attention where the model attends, the
    MoE dispatch and combine where it has experts.  With ``profile``, then
    trace one warm prefill and 12 decode steps at batch 4 (not counted in
    the numbers above)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import device as D
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import init_model
    from repro_torch.roofline import hw, model_flops
    from repro_torch.serving.engine import make_prefill_step

    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(seed), cfg,
                        torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())

    n_params = count(params)
    print(f"model: {cfg.name} at {cfg.num_layers} of {full.num_layers} "
          f"layers, d_model {cfg.d_model}, mixers "
          f"{sorted({m for m, _ in cfg.prefix + cfg.pattern})} "
          f"({cfg.attn_type if cfg.uses_attention else 'no attention'}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads), "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
          f"{n_params} parameters in bf16 "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), made in "
          f"{init_s:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN))).to(dev)
    step = make_prefill_step(cfg)
    D.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    prefill_s = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del cache
    (host,) = D.to_host([logits])
    if host.shape != (PREFILL_BATCH, cfg.vocab_size):
        fail(f"prefill logits have shape {host.shape}")
    if not np.isfinite(host).all():
        fail("prefill logits are not finite")
    peak = torch.cuda.max_memory_allocated()
    n_tok = PREFILL_BATCH * PREFILL_LEN
    prefill_launches = D.launch_counts()
    if cfg.uses_attention and prefill_launches["flash_attention"] <= 0:
        fail(f"the prefill did not launch the bf16 flash_attention kernel "
             f"({prefill_launches})")
    flops = model_flops(cfg, ShapeSpec("prefill", PREFILL_LEN, PREFILL_BATCH,
                                       "prefill"))
    least_s = flops / hw.PEAK_FLOPS_BF16
    print(f"prefill {PREFILL_BATCH} x {PREFILL_LEN}: cold {prefill_s[0]:.3f}"
          f" s, warm {prefill_s[1]:.3f} s ({n_tok / prefill_s[1]:.0f} "
          f"tokens/s), peak device memory {peak / 2**30:.2f} GiB, launches "
          f"{prefill_launches}; model flops {flops:.4g} (the reference's "
          f"formula), over the bf16 peak {least_s * 1e3:.3f} ms, so the "
          f"warm prefill ran at {least_s / prefill_s[1]:.2%} of it",
          flush=True)
    reqs = make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, seed)
    step_s = []
    rep = serve(params, cfg, reqs, SERVE_BATCH, device=dev,
                step_seconds=step_s, log=None)
    launches = D.launch_counts()
    if rep["served"] != SERVE_REQUESTS or any(
            len(r.output) != SERVE_NEW for r in reqs):
        fail(f"serving: {rep['served']} of {SERVE_REQUESTS} requests served")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        fail("serving produced a token outside the vocabulary")
    needed = ["radix_sort_pass"]
    if cfg.uses_attention:
        needed.append("flash_attention")
    if cfg.uses_moe:
        needed += ["moe_dispatch", "moe_combine"]
    for k in needed:
        if launches[k] <= 0:
            fail(f"{cfg.name} serving: kernel {k} was not launched "
                 f"({launches})")
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        from repro_torch.serving.engine import generate

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with trace(activities=acts) as prof:
            t0 = time.perf_counter()
            step(params, {"tokens": toks})
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        print_profile(f"{cfg.name} prefill", prof, wall_us)
        prompts = np.stack([r.prompt[:8] for r in reqs[:SERVE_BATCH]])
        with trace(activities=acts) as prof:
            t0 = time.perf_counter()
            generate(params, cfg, prompts, 5)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        print_profile(f"{cfg.name} decode (12 steps, batch 4)", prof,
                      wall_us)
    p50_ms = statistics.median(step_s) * 1e3
    tok_s = rep["tokens"] / rep["seconds"]
    print(f"{cfg.name}: serve {SERVE_REQUESTS} requests (prompt "
          f"{SERVE_PROMPT}, "
          f"{SERVE_NEW} new, batch {SERVE_BATCH}): {rep['tokens']} tokens in "
          f"{rep['seconds']:.2f} s ({tok_s:.1f} tokens/s), decode step p50 "
          f"{p50_ms:.2f} ms over {len(step_s)} steps, batches "
          f"{rep['batches']}, launches {launches}", flush=True)
    report = {"arch": cfg.name, "layers": cfg.num_layers,
              "params": n_params, "init_s": init_s,
              "prefill_cold_s": prefill_s[0], "prefill_warm_s": prefill_s[1],
              "prefill_tokens_per_s": n_tok / prefill_s[1],
              "prefill_peak_bytes": peak, "prefill_model_flops": flops,
              "prefill_bf16_peak_share": least_s / prefill_s[1],
              "serve_tokens": rep["tokens"], "serve_s": rep["seconds"],
              "serve_tokens_per_s": tok_s, "decode_step_p50_ms": p50_ms,
              "decode_steps": len(step_s),
              "prefill_launches": prefill_launches, "launches": launches}
    del params, logits, step
    return report, launches


def lm_agreement(seed: int) -> dict:
    """The smoke configs on the card and on the CPU, same float32 weights:
    prefill logits within 2e-4 (the reference's prefill tolerance; float32
    matmuls in full precision) and generate's tokens equal.  Returns the
    launch counts of the run, from 0: the float32 attention kernel's."""
    import numpy as np
    import torch

    from repro_torch import device as D
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.serving.engine import generate, make_prefill_step

    def to(tree, dev):
        return {k: (to(v, dev) if isinstance(v, dict) else v.to(dev))
                for k, v in tree.items()}

    D.reset_launch_counts()
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        cpu = init_model(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
        card = to(cpu, torch.device("cuda"))
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (2, 32))
        out = {}
        for where, p in (("cuda", card), ("cpu", cpu)):
            logits, _ = make_prefill_step(cfg)(
                p, {"tokens": torch.from_numpy(toks).to(where)})
            out[where] = (logits.cpu(), generate(p, cfg, toks[:, :8], 8))
        err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        if not torch.isfinite(out["cuda"][0]).all() or not torch.allclose(
                out["cuda"][0], out["cpu"][0], rtol=2e-4, atol=2e-4):
            fail(f"{arch}: prefill logits on the card and the CPU differ "
                 f"by {err}")
        if not np.array_equal(out["cuda"][1], out["cpu"][1]):
            fail(f"{arch}: generate's tokens differ between the card and "
                 f"the CPU")
        print(f"{arch} smoke: card/CPU prefill max abs diff {err:.3g}, "
              f"generate tokens equal", flush=True)
    launches = D.launch_counts()
    if launches["flash_attention_f32"] <= 0:
        fail(f"the float32 smoke configs did not launch flash_attention_f32 "
             f"({launches})")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: training Phi-3.5-MoE at full width on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
#: AdamW's learning rate at full width.  The reference's default, 3e-4
#: (its smoke configs', d_model 64), overshoots at d_model 4096 without a
#: warmup: the loss rose from 11.37 to 15.40 and 17.97 over three steps on
#: the repeated batch (H100 80GB HBM3, 700.00 W), while at 1e-5, 3e-5 and
#: 1e-4 it fell.  3e-5 is the size of the first steps of a warmup to a
#: peak of a few 1e-4.
TRAIN_LR = 3e-5


def _grads_set(params) -> None:
    from repro_torch.train.tree import tree_paths

    missing = ["|".join(p) for p, t in tree_paths(params) if t.grad is None]
    if missing:
        fail(f"training: {len(missing)} parameters have no gradient "
             f"({missing[:5]})")


def train_phase(seed: int, profile: bool = False):
    """Phase 8: ``repro_torch.data.pipeline`` on the card (the reference's
    ``PipelineConfig`` defaults: 20,000 documents, policy ``auto``, 1 MB of
    work_mem; seq 4096, batch 2), then Phi-3.5-MoE at full width and
    ``TRAIN_LAYERS`` of its 32 layers in float32 (random weights from
    ``seed``), ``make_train_step`` with the reference's default policy
    (AdamW at ``TRAIN_LR``, recomputation per period) for
    ``TRAIN_STEPS`` steps on the pipeline's first batch repeated, a
    checkpoint (``train/checkpoint``),
    a fourth step, then a restart from the checkpoint and the fourth step
    again.  Counters from 0 before the pipeline, read after the restarted
    step.  Fails on a loss that is not finite, a parameter without a
    gradient, a third loss not below the first, or a restarted fourth step
    that differs from the uninterrupted one (its loss bit for bit, the
    parameters within 1e-6: the card sums the embedding's gradient with
    atomics, in any order).  Then, on the emptied card, the same steps in
    bf16 (:func:`train_bf16_run`).  Returns (report, launch counts of each
    run: ``{"float32": ..., "bfloat16": ...}``)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch import device as D
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import (PipelineConfig, batches,
                                           prepare_order)
    from repro_torch.models import init_model
    from repro_torch.roofline import hw, model_flops
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import default_policy, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    report = {"arch": cfg.name, "layers": cfg.num_layers}

    # the pipeline: its relational join and sort on the card
    D.reset_launch_counts()
    pcfg = PipelineConfig(vocab=cfg.vocab_size, seq_len=PREFILL_LEN,
                          batch_size=PREFILL_BATCH, seed=seed, device="cuda")
    t0 = time.perf_counter()
    ordered, metrics, decisions = prepare_order(pcfg)
    first = next(batches(pcfg, ordered))
    report["pipeline_s"] = time.perf_counter() - t0
    pipe_launches = {k: v for k, v in D.launch_counts().items()
                     if k in D.RELATIONAL_KERNELS}
    paths = [dd.path for dd in decisions]
    print(f"train pipeline ({pcfg.num_docs} documents, policy "
          f"{pcfg.policy}, work_mem {pcfg.work_mem} B): "
          f"{report['pipeline_s']:.2f} s, {len(ordered)} documents kept, "
          f"ops {[m.op for m in metrics]}, paths {paths}, relational "
          f"launches {pipe_launches}", flush=True)
    if paths[0] == "linear":
        print("train pipeline: at this size the selector took the linear "
              "(host) path for the dedup join, so it launched no "
              "relational kernel", flush=True)
    # the same pipeline forced onto the tensor path must give the same batch
    tcfg = dataclasses.replace(pcfg, policy="tensor")
    before = D.launch_counts()
    t_ordered, _, _ = prepare_order(tcfg)
    tensor_launches = {k: v - before[k] for k, v in D.launch_counts().items()
                       if k in D.RELATIONAL_KERNELS}
    t_first = next(batches(tcfg, t_ordered))
    if not all(np.array_equal(first[k], t_first[k]) for k in first):
        fail("the pipeline's first batch differs between the auto and "
             "tensor policies")
    print(f"train pipeline under policy tensor: the same first batch, "
          f"relational launches {tensor_launches}", flush=True)
    report["pipeline_launches"] = pipe_launches
    report["pipeline_tensor_launches"] = tensor_launches

    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(seed), cfg,
                        torch.float32, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = adamw(lr=TRAIN_LR)
    state = opt.init(params)
    policy = default_policy(cfg)
    step = make_train_step(cfg, opt, policy)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    torch.cuda.synchronize()
    print(f"train model: {cfg.name} at {cfg.num_layers} of "
          f"{full.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token} of "
          f"{cfg.moe_d_ff}, {n_params} parameters in float32 with AdamW "
          f"state ({torch.cuda.memory_allocated() / 2**30:.2f} GiB), made "
          f"in {time.perf_counter() - t0:.2f} s; AdamW lr {TRAIN_LR}, "
          f"policy {policy}",
          flush=True)
    n_tok = PREFILL_BATCH * PREFILL_LEN
    flops = model_flops(cfg, ShapeSpec("train", PREFILL_LEN, PREFILL_BATCH,
                                       "train"))
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def run_step(i, params, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not np.isfinite(loss):
            fail(f"training step {i}: loss {loss}")
        _grads_set(params)
        rec = {"step": i, "loss": loss, "grad_norm": gnorm, "s": dt,
               "tokens_per_s": n_tok / dt,
               "f32_peak_share": flops / hw.PEAK_FLOPS_F32 / dt,
               "tf32_peak_share": flops / hw.PEAK_FLOPS_TF32 / dt}
        print(f"train step {i}: loss {loss:.6f}, grad norm {gnorm:.4f}, "
              f"{dt:.3f} s, {rec['tokens_per_s']:.0f} tokens/s, model flops "
              f"{flops:.4g} at {rec['f32_peak_share']:.2%} of the float32 "
              f"peak ({rec['tf32_peak_share']:.2%} of TF32's)", flush=True)
        return params, state, rec

    for i in range(1, TRAIN_STEPS + 1):
        params, state, rec = run_step(i, params, state)
        steps.append(rec)
    if not steps[-1]["loss"] < steps[0]["loss"]:
        fail(f"training: step {TRAIN_STEPS}'s loss {steps[-1]['loss']} is "
             f"not below step 1's {steps[0]['loss']} on a repeated batch")
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"train peak device memory {report['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)

    ckpt_dir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt_dir), TRAIN_STEPS, (params, state))
    report["ckpt_save_s"] = time.perf_counter() - t0
    params, state, rec4 = run_step(TRAIN_STEPS + 1, params, state)
    after = [p.detach().cpu() for p in tree_leaves(params)]
    # the restart: the state freed, a template of empty tensors naming each
    # leaf's device, dtype and requires_grad
    template = tree_map(lambda t: torch.empty(0, dtype=t.dtype, device=dev
                                              ).requires_grad_(
        t.requires_grad), (params, state))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (params, state), at = restore_checkpoint(str(ckpt_dir), template)
    report["ckpt_restore_s"] = time.perf_counter() - t0
    if at != TRAIN_STEPS or int(state["step"]) != TRAIN_STEPS:
        fail(f"restored step {at}, optimizer step {int(state['step'])}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, rec_r = run_step(TRAIN_STEPS + 1, params, state)
            wall_us = (time.perf_counter() - t0) * 1e6
        print_profile("train step (restarted step 4, traced)", prof,
                      wall_us, top=16)
    else:
        params, state, rec_r = run_step(TRAIN_STEPS + 1, params, state)
    same = 0
    worst = 0.0
    for a, b in zip(after, tree_leaves(params)):
        b = b.detach().cpu()
        same += int(torch.equal(a, b))
        worst = max(worst, float((a - b).abs().max()))
    print(f"train restart: checkpoint of step {TRAIN_STEPS} saved in "
          f"{report['ckpt_save_s']:.1f} s, restored in "
          f"{report['ckpt_restore_s']:.1f} s; step {TRAIN_STEPS + 1} loss "
          f"{rec4['loss']!r} uninterrupted, {rec_r['loss']!r} restarted; "
          f"{same} of {len(after)} parameter tensors bit-equal, max abs "
          f"diff {worst:.3g}", flush=True)
    if rec_r["loss"] != rec4["loss"] or not worst <= 1e-6:
        fail("training: the restarted step differs from the uninterrupted "
             "one")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = D.launch_counts()
    needed = ("flash_attention_f32", "flash_attention_bwd_f32",
              "moe_dispatch", "moe_combine", "moe_combine_weight_grad")
    for k in needed:
        if launches[k] <= 0:
            fail(f"training: kernel {k} was not launched ({launches})")
    print(f"train launches (pipeline, {TRAIN_STEPS + 2} steps): {launches}",
          flush=True)
    report.update(params=n_params, steps=steps + [rec4], restarted=rec_r,
                  model_flops=flops, restart_max_abs_diff=worst,
                  restart_bit_equal_tensors=same, launches=launches)
    del params, state, after, template
    gc.collect()
    torch.cuda.empty_cache()
    report["bf16"], bf16_launches = train_bf16_run(
        dev, seed, cfg, batch, steps[0]["loss"], flops, profile)
    return report, {"float32": launches, "bfloat16": bf16_launches}


#: the bf16 run's first loss against the float32 run's (the same weights
#: before the bf16 rounding), relative
TRAIN_BF16_LOSS_RTOL = 2e-2


def train_bf16_run(dev, seed: int, cfg, batch, f32_loss: float,
                   flops: float, profile: bool = False):
    """Phase 8's bf16 run: the float32 run's cut and batch, its initial
    weights rounded to bf16 (``init_model`` draws in float32 and rounds;
    the router stays float32), AdamW at ``TRAIN_LR`` with float32 state,
    the reference's default policy, ``TRAIN_STEPS`` + 1 steps, no
    checkpoint.  Counters from 0 before the first step.  Fails on a loss
    that is not finite, a parameter without a gradient, a last loss not
    below the first, a first loss farther than ``TRAIN_BF16_LOSS_RTOL``
    from the float32 run's, or a step that launched no bf16 forward with
    its logsumexp or no bf16 backward.  With ``profile``, the last step is
    traced.  Returns (report, launch counts)."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    from repro_torch import device as D
    from repro_torch.models import init_model
    from repro_torch.roofline import hw
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import default_policy, make_train_step
    from repro_torch.train.tree import tree_leaves

    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(seed), cfg,
                        torch.bfloat16, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    dtypes = sorted({str(p.dtype) for p in tree_leaves(params)})
    opt = adamw(lr=TRAIN_LR)
    state = opt.init(params)
    step = make_train_step(cfg, opt, default_policy(cfg))
    torch.cuda.synchronize()
    print(f"train bf16 model: {cfg.name} at {cfg.num_layers} layers, the "
          f"float32 run's initial weights rounded to bf16 (leaf dtypes "
          f"{dtypes}), AdamW state float32 "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_tok = PREFILL_BATCH * PREFILL_LEN
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    steps = []
    for i in range(1, TRAIN_STEPS + 2):
        traced = profile and i == TRAIN_STEPS + 1
        with (trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if traced else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if traced:
            print_profile(f"train bf16 step {i} (traced)", prof, dt * 1e6,
                          top=32)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not np.isfinite(loss):
            fail(f"bf16 training step {i}: loss {loss}")
        _grads_set(params)
        rec = {"step": i, "loss": loss, "grad_norm": gnorm, "s": dt,
               "tokens_per_s": n_tok / dt, "traced": traced,
               "bf16_peak_share": flops / hw.PEAK_FLOPS_BF16 / dt}
        steps.append(rec)
        print(f"train bf16 step {i}: loss {loss:.6f}, grad norm "
              f"{gnorm:.4f}, {dt:.3f} s, {rec['tokens_per_s']:.0f} tokens/s, "
              f"model flops at {rec['bf16_peak_share']:.2%} of the bf16 "
              f"peak" + (" (traced)" if traced else ""), flush=True)
    launches = D.launch_counts()
    report = {"steps": steps, "peak_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "leaf_dtypes": dtypes,
              "first_loss_rel_to_f32": abs(steps[0]["loss"] - f32_loss)
              / abs(f32_loss)}
    per_step = {k: v / len(steps) for k, v in launches.items() if v}
    print(f"train bf16 peak device memory {report['peak_bytes'] / 2**30:.2f} "
          f"GiB; first loss {steps[0]['loss']!r} against the float32 run's "
          f"{f32_loss!r} ({report['first_loss_rel_to_f32']:.3g} relative, "
          f"tol {TRAIN_BF16_LOSS_RTOL}); launches a step {per_step}",
          flush=True)
    if not report["first_loss_rel_to_f32"] <= TRAIN_BF16_LOSS_RTOL:
        fail("bf16 training: the first loss is too far from the float32 "
             "run's")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        fail(f"bf16 training: the last loss {steps[-1]['loss']} is not "
             f"below the first {steps[0]['loss']} on a repeated batch")
    for k in ("flash_attention_lse", "flash_attention_bwd_bf16",
              "moe_dispatch", "moe_combine", "moe_combine_weight_grad"):
        if launches[k] < len(steps):
            fail(f"bf16 training: kernel {k} launched {launches[k]} times in "
                 f"{len(steps)} steps ({launches})")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches


def train_row_launches(rows, launches) -> None:
    """Each training row's launches: the float32 run's for rows at
    ``TRAIN_AT``, the bf16 run's for the others."""
    for r in rows:
        run = "float32" if r["at"] == TRAIN_AT else "bfloat16"
        r["launches"] = launches[run][r["name"]]


def train_calls(dev, seed: int, profile: bool = False) -> dict:
    """``--only train``: phase 2's training rows, then phase 8."""
    rows = train_kernel_phase(dev, seed)
    report, launches = train_phase(seed, profile)
    train_row_launches(rows, launches)
    return {"train": report, "kernels": rows}


# ---------------------------------------------------------------------------
# Phase 9: the LM on a mesh: a one-card NCCL mesh, and the production dry-run
# ---------------------------------------------------------------------------

MESH_STEPS = 2
#: the production cells the dry-run plans here, each in a process of its
#: own under the fake process group (it cannot share a process with NCCL)
DRYRUN_CELLS = (("phi3.5-moe-42b-a6.6b", "train_4k"),
                ("deepseek-v2-lite-16b", "prefill_32k"))
DRYRUN_TIMEOUT = 900
#: the CUDA caching allocator's granule (every block is a multiple of
#: it), and the largest segment remainder a block above it keeps unsplit
ALLOC_GRANULE = 512
ALLOC_UNSPLIT = 1 << 20

# the dry-run's argument bytes for phase 9's cut on a (data, model) mesh
# (rank 0's shards), planned on the meta device in a process of its own
_PLAN_ARGS = """
import json, sys, dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
arch, layers, batch, seq, data, model = sys.argv[1], *map(int, sys.argv[2:])
cfg = dataclasses.replace(get_config(arch), num_layers=layers)
with D.fake_group(data * model):
    mesh = make_local_mesh(data, model, device_type="cpu")
    _, args = D.build_cell(cfg, ShapeSpec("mesh", seq, batch, "train"), mesh,
                           {"microbatches": 1}, dtype=torch.float32)
    print(json.dumps(D.argument_bytes(args)))
"""


def _start_dryrun(root: Path, out: Path) -> list:
    """The production dry-run's cells, one process each, started now so
    they plan (on the CPU) while the card runs the mesh steps."""
    env = dict(__import__("os").environ, PYTHONPATH=str(root / "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        procs.append((arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def _finish_dryrun(procs, out: Path) -> dict:
    """Wait for the dry-run's cells (killed at ``DRYRUN_TIMEOUT``), print
    each record's per-device figures, fail on a record that is not ok."""
    records = {}
    for arch, shape, proc in procs:
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dry-run {arch} x {shape}: still running after "
                 f"{DRYRUN_TIMEOUT} s")
        path = out / f"{arch}__{shape}__single.json"
        if proc.returncode != 0 or not path.is_file():
            fail(f"dry-run {arch} x {shape}: exit {proc.returncode}\n"
                 f"{log[-3000:]}")
        r = json.loads(path.read_text())
        if r["status"] != "ok":
            fail(f"dry-run {arch} x {shape}: {r['status']} "
                 f"{r.get('error')}\n{r.get('traceback', '')[-2000:]}")
        ma, rl = r["memory_analysis"], r["roofline"]
        print(f"dry-run {arch} x {shape} x single (16 x 16, predictions "
              f"per device, not measured): arguments "
              f"{ma['argument_size_in_bytes'] / 2**30:.3f} GiB, temp "
              f"{ma['temp_size_in_bytes'] / 2**30:.3f} GiB, counted flops "
              f"{r['dispatch_walk']['flops']:.4g} (model "
              f"{r['model_flops_per_device']:.4g}, useful ratio "
              f"{r['useful_flops_ratio']:.4f}), collective bytes "
              f"{r['dispatch_walk']['collective_bytes']:.4g}; roofline "
              f"compute {rl['t_compute_s']:.4f} s, memory "
              f"{rl['t_memory_s']:.4f} s, collective "
              f"{rl['t_collective_s']:.4f} s: {rl['dominant']}; traced at "
              f"{r['traced']['periods_microbatches']} (periods, "
              f"microbatches) in {r['traced']['trace_s']} s", flush=True)
        records[f"{arch}x{shape}"] = r
    return records


def _plan(root: Path, data: int, model: int) -> subprocess.Popen:
    """Start the dry-run's plan of phase 9's cut on a (data, model) mesh in
    a process of its own; :func:`_planned` reads its per-tensor bytes."""
    return subprocess.Popen(
        [sys.executable, "-c", _PLAN_ARGS, LM_ARCH, str(TRAIN_LAYERS),
         str(PREFILL_BATCH), str(PREFILL_LEN), str(data), str(model)],
        env=dict(__import__("os").environ, PYTHONPATH=str(root / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _planned(proc: subprocess.Popen, label: str) -> list:
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{label}: the dry-run plan is still running after 600 s")
    if proc.returncode != 0:
        fail(f"{label}: the dry-run plan failed\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _mesh_model(seed: int, dev):
    """Phase 9's cut on ``dev``: ``(cfg, step, fresh)``, where ``fresh()``
    makes the weights from ``seed`` (the same on every card), AdamW's state
    and the batch."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.trainer import default_policy, make_train_step
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=TRAIN_LAYERS)
    rng = np.random.default_rng(seed)
    batch_np = {k: rng.integers(0, cfg.vocab_size, (PREFILL_BATCH,
                                                    PREFILL_LEN),
                                dtype=np.int32) for k in ("tokens", "labels")}
    opt = adamw(lr=TRAIN_LR)
    step = make_train_step(cfg, opt, default_policy(cfg))

    def fresh():
        params = init_model(torch.Generator(device=dev).manual_seed(seed),
                            cfg, torch.float32, device=dev)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params, opt.init(params), {
            k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    return cfg, step, fresh


def _mesh_losses(step, params, state, batch, scope,
                 steps: int = MESH_STEPS) -> list:
    """``steps`` steps: ``(loss, seconds)`` of each."""
    import torch

    out = []
    with scope:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            loss = m["loss"]
            loss = float(loss.full_tensor() if hasattr(
                loss, "full_tensor") else loss)
            torch.cuda.synchronize()
            out.append((loss, time.perf_counter() - t0))
    return out


def _laid_out(label: str, mesh, cfg, fresh, planned: list):
    """The model laid out on ``mesh`` by ``param_specs`` / ``batch_specs``,
    its bytes on this rank's card held to the dry-run's ``planned`` ones,
    each block rounded up to the allocator's ``ALLOC_GRANULE`` and a block
    above ``ALLOC_UNSPLIT`` keeping its 2 MiB segment's remainder when
    that is no larger.  Returns ``(params, state, batch, figures)``."""
    import torch

    from repro_torch.distributed.sharding import (PartitionSpec,
                                                  batch_specs,
                                                  distribute_tree,
                                                  param_specs)
    from repro_torch.train.tree import tree_leaves

    # the group's and DTensor's one-time state (the communicators of both
    # axes, the RNG tracker) made before the count starts: none of it is
    # the model's
    before = torch.cuda.memory_allocated()
    width = max(mesh.shape)
    distribute_tree(torch.zeros(width, width, device="cuda"), mesh,
                    PartitionSpec(*mesh.mesh_dim_names))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params, state, batch = fresh()
    params = distribute_tree(params, mesh, param_specs(params, cfg))
    state = distribute_tree(state, mesh, param_specs(state, cfg))
    batch = distribute_tree(batch, mesh, batch_specs(batch, mesh))
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    on_card = [t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves((params, state, batch))]
    rounded = sum(-(-n // ALLOC_GRANULE) * ALLOC_GRANULE for n in planned)
    large = sum(n > ALLOC_UNSPLIT for n in planned)
    unsplit = held - rounded
    figures = {"arch": cfg.name, "layers": cfg.num_layers,
               "first_layout_bytes": base - before,
               "argument_bytes": sum(on_card), "tensors": len(on_card),
               "planned_bytes": sum(planned), "allocated_bytes": held,
               "planned_rounded_bytes": rounded, "unsplit_bytes": unsplit,
               "large_blocks": large}
    if on_card != planned or not 0 <= unsplit <= large * ALLOC_UNSPLIT \
            or unsplit % ALLOC_GRANULE:
        fail(f"{label}: the card's argument bytes differ from the dry-run's "
             f"plan ({figures})")
    return params, state, batch, figures


def _print_layout(label: str, f: dict) -> None:
    print(f"{label}: the group's first layout left "
          f"{f['first_layout_bytes']} B allocated; {f['arch']} at "
          f"{f['layers']} layers, float32, AdamW: {f['tensors']} argument "
          f"tensors, {f['argument_bytes']} B on the card's shards, the "
          f"dry-run plans {f['planned_bytes']} B; allocated "
          f"{f['allocated_bytes']} B = the plan + "
          f"{f['planned_rounded_bytes'] - f['planned_bytes']} B of rounding "
          f"to {ALLOC_GRANULE}-byte blocks + {f['unsplit_bytes']} B of "
          f"segment remainders kept unsplit (at most {ALLOC_UNSPLIT} B in "
          f"each of the {f['large_blocks']} blocks above it)", flush=True)


MESH_KERNELS = ("flash_attention_f32", "flash_attention_bwd_f32",
                "moe_dispatch", "moe_combine", "moe_combine_weight_grad")


def mesh_phase(seed: int, root: Path):
    """Phase 9.  The production dry-run's two cells start in their own
    processes.  Meanwhile, on the card: a process group of one rank over
    NCCL and ``make_local_mesh(1, 1)``; Phi-3.5-MoE at full width and
    ``TRAIN_LAYERS`` layers in float32 with AdamW (``TRAIN_LR``), its
    parameters, AdamW state and batch laid out by ``param_specs`` /
    ``batch_specs`` as DTensors, whose bytes on the card must equal the
    dry-run's per-device argument bytes for the same cut on a (1, 1) mesh,
    apart from the allocator's rounding (:func:`_laid_out`);
    ``MESH_STEPS`` steps of ``make_train_step`` under the mesh (counters
    from 0: the flash-attention forward and backward, dispatch, combine and
    ``moe_combine_weight_grad`` must launch), then the group torn down and
    the same steps unsharded from the same weights, whose losses the
    sharded ones must equal within 1e-6 (relative).  Then the dry-run's
    records (each must be ok).  Returns (report, launch counts)."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import device as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.pspec import mesh_scope

    out = root / "build" / "dryrun_torch"
    procs = _start_dryrun(root, out)
    plan = _plan(root, 1, 1)
    dev = torch.device("cuda")
    cfg, step, fresh = _mesh_model(seed, dev)
    planned = _planned(plan, "mesh")
    report = {"arch": cfg.name, "layers": cfg.num_layers}

    # the group meets through a file (no TCP port another run could take)
    rdzv = tempfile.mkdtemp(prefix="rdzv")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/store",
                            rank=0, world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh = make_local_mesh(1, 1)
        params, state, batch, figures = _laid_out("mesh", mesh, cfg, fresh,
                                                  planned)
        _print_layout("mesh (1, 1) over NCCL", figures)
        D.reset_launch_counts()
        sharded = _mesh_losses(step, params, state, batch, mesh_scope(mesh))
        launches = D.launch_counts()
        del params, state, batch
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    plain = _mesh_losses(step, *fresh(), contextlib.nullcontext())
    gc.collect()
    torch.cuda.empty_cache()
    for i, ((ls, ts), (lp, tp)) in enumerate(zip(sharded, plain), 1):
        print(f"mesh step {i}: loss {ls!r} sharded ({ts:.3f} s), {lp!r} "
              f"unsharded ({tp:.3f} s), relative difference "
              f"{abs(ls - lp) / abs(lp):.3g}", flush=True)
        if not np.isfinite(ls) or abs(ls - lp) > 1e-6 * abs(lp):
            fail(f"mesh step {i}: sharded loss {ls} against {lp}")
    for k in MESH_KERNELS:
        if launches[k] <= 0:
            fail(f"mesh: kernel {k} was not launched ({launches})")
    print(f"mesh launches ({MESH_STEPS} sharded steps): {launches}",
          flush=True)
    report.update(argument_bytes=figures["argument_bytes"],
                  planned_bytes=figures["planned_bytes"],
                  allocated_bytes=figures["allocated_bytes"],
                  planned_rounded_bytes=figures["planned_rounded_bytes"],
                  sharded_losses=[x for x, _ in sharded],
                  unsharded_losses=[x for x, _ in plain],
                  sharded_s=[t for _, t in sharded],
                  unsharded_s=[t for _, t in plain], launches=launches)
    report["dryrun"] = _finish_dryrun(procs, out)
    return report, launches


# ---------------------------------------------------------------------------
# Phase 10 (--only cards): the port on four cards
# ---------------------------------------------------------------------------

CARDS = 4
#: Q-a's eight partitions on 1, 2 and 4 cards
CARD_PLACEMENTS = ("cuda:0", ("cuda:0", "cuda:1"), "cuda")
#: warm runs of each placement's Q-a (phase 3's five leave the p50 to
#: chance on four cards)
CARD_WARM_RUNS = 20
MESH4 = (2, 2)
MESH4_STEPS = 3       # the first pays NCCL's and the kernels' first calls
MESH4_TOL = 1e-4      # NCCL's reductions reorder float32 sums
MESH4_TIMEOUT = 900


def mesh_rank(rank: int, world: int, root: str, rdzv: str, seed: int,
              out: str, planned: list) -> None:
    """One rank of phase 10's step, on card ``rank`` of a ``MESH4`` NCCL
    mesh: phase 9's model laid out and held to the dry-run's ``planned``
    bytes (:func:`_laid_out`), ``MESH4_STEPS`` steps under the mesh with
    the rank's own launch counts, the group torn down; rank 0 then runs
    the same steps unsharded from the same weights.  Writes its report to
    ``out/rank<rank>.json``."""
    sys.path.insert(0, str(Path(root) / "src"))
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch import device as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.pspec import mesh_scope

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world, device_id=dev)
    cfg, step, fresh = _mesh_model(seed, dev)
    report = {"rank": rank}
    try:
        mesh = make_local_mesh(*MESH4)
        params, state, batch, figures = _laid_out(
            f"mesh {MESH4} rank {rank}", mesh, cfg, fresh, planned)
        D.reset_launch_counts()
        report["sharded"] = _mesh_losses(step, params, state, batch,
                                         mesh_scope(mesh), MESH4_STEPS)
        report.update(launches=D.launch_counts(), layout=figures,
                      peak_allocated_bytes=torch.cuda.max_memory_allocated())
        del params, state, batch
    finally:
        dist.destroy_process_group()
    if rank == 0:
        gc.collect()
        torch.cuda.empty_cache()
        report["unsharded"] = _mesh_losses(step, *fresh(),
                                           contextlib.nullcontext(),
                                           MESH4_STEPS)
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))


def mesh4_phase(seed: int, root: Path) -> dict:
    """(4) phase 9's step on a ``MESH4`` mesh of ``CARDS`` NCCL ranks, a
    card each (:func:`mesh_rank`, spawned here and stopped on any
    failure): every rank's bytes are the dry-run's plan for that mesh
    apart from the allocator's rounding, and the float32 attention forward
    and backward, dispatch, combine and the routing-weight gradient launch
    on every rank; the sharded losses must be within ``MESH4_TOL``
    (relative) of the unsharded ones."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    planned = _planned(_plan(root, *MESH4), f"mesh {MESH4}")
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="rdzv"))
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        mesh_rank, args=(CARDS, str(root), str(tmp / "store"), seed,
                         str(tmp), planned),
        nprocs=CARDS, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + MESH4_TIMEOUT
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                fail(f"mesh {MESH4}: ranks still running after "
                     f"{MESH4_TIMEOUT} s")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(CARDS)]
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r in ranks:
        _print_layout(f"mesh {MESH4} over NCCL, rank {r['rank']}",
                      r["layout"])
        missing = [k for k in MESH_KERNELS if r["launches"][k] <= 0]
        if missing:
            fail(f"mesh {MESH4} rank {r['rank']}: kernels {missing} were "
                 f"not launched ({r['launches']})")
        print(f"mesh {MESH4} rank {r['rank']} launches ({MESH4_STEPS} "
              f"steps): {r['launches']}; peak allocated "
              f"{r['peak_allocated_bytes']} B", flush=True)
        if [x for x, _ in r["sharded"]] != [x for x, _ in
                                            ranks[0]["sharded"]]:
            fail(f"mesh {MESH4}: rank {r['rank']}'s losses differ from "
                 f"rank 0's")
    sharded, plain = ranks[0]["sharded"], ranks[0]["unsharded"]
    for i, ((ls, ts), (lp, tp)) in enumerate(zip(sharded, plain), 1):
        print(f"mesh {MESH4} step {i}: loss {ls!r} sharded on {CARDS} cards "
              f"({ts:.3f} s), {lp!r} unsharded on one ({tp:.3f} s), "
              f"relative difference {abs(ls - lp) / abs(lp):.3g}",
              flush=True)
        if not np.isfinite(ls) or abs(ls - lp) > MESH4_TOL * abs(lp):
            fail(f"mesh {MESH4} step {i}: sharded loss {ls} against {lp}")
    return {"mesh": list(MESH4), "ranks": ranks, "wall_s": wall,
            "sharded_losses": [x for x, _ in sharded],
            "unsharded_losses": [x for x, _ in plain],
            "sharded_s": [t for _, t in sharded],
            "unsharded_s": [t for _, t in plain]}


def cards_calls(seed: int, root: Path) -> dict:
    """``--only cards``: phase 10 on fresh SF1 tables, ``CARDS`` cards."""
    import torch

    orders, lineitem = tpch(1.0, seed)
    want = oracle(orders, lineitem)
    out = {"cards": torch.cuda.device_count(),
           "partition_pass_s": partition_pass_s(orders, lineitem), "Q-a": {}}
    for device in CARD_PLACEMENTS:   # (1) Q-a on 1, 2 and 4 cards
        r = sharded_qa(orders, lineitem, want["Q-a"], device=device,
                       runs=CARD_WARM_RUNS)
        print_sharded_qa(r, out["partition_pass_s"])
        out["Q-a"][len(r["cards"])] = r
        gc.collect()
        torch.cuda.empty_cache()
    out["fig15"] = sharded_fig15(seed)   # (2)
    for shards in SHARDS:
        print_fig15(shards, out["fig15"][shards])
    out["serving"] = r = sharded_serving(orders, lineitem, want)   # (3)
    print(f"sharded closed loop on {len(placed_on('cuda'))} cards (Q-a, 8 "
          f"workers x 4): {r['counts']}, p50 {r['p50_s']:.4f} s, p99 "
          f"{r['p99_s']:.4f} s, {r['qps']:.1f} q/s, lane dispatches "
          f"{r['lane_dispatches']}", flush=True)
    del orders, lineitem, want
    out["mesh"] = mesh4_phase(seed, root)   # (4)
    return out


#: the ``--only`` phases besides ``lm`` (phase 6, run by ``lm_serving``)
ONLY = {"moe-dispatch": dispatch_calls, "moe-layer": moe_layer_calls,
        "join-build": join_build_calls, "join-probe": join_probe_calls,
        "segment-sum": segment_sum_calls, "sharded": sharded_calls,
        "pressure": pressure_calls}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each query, and one "
                         "warm prefill and 12 decode steps of each LM with "
                         "torch.profiler, and print where the time goes")
    ap.add_argument("--only", choices=(*ONLY, "lm", "train", "dryrun",
                                       "cards"),
                    help="run one phase alone and print its numbers as one "
                         "JSON line, to compare two checkouts in turns on "
                         "one card: moe-dispatch times the layer body's "
                         "dispatch call and moe-layer the layer body with "
                         "an identity FFN at the decode and prefill "
                         "shapes, join-build the table build at Q-a's "
                         "build shape and then Q-a and Q-b, join-probe "
                         "radix_hash_probe at Q-a's shape (probe codes in "
                         "order and shuffled) and then Q-a and Q-b, "
                         "segment-sum the segment sum's cases at Q-c's "
                         "shape and then Q-c and Q-e, sharded is phase 5b "
                         "after the single-device Q-a, pressure is phase 4b "
                         "(the memory-pressure checks), lm is phase 6, "
                         "train is phase 2's training rows and phase 8 "
                         "(with --profile, their traces), dryrun is phase 9 "
                         "(the one-card mesh and the production dry-run), "
                         "cards is phase 10 (four cards: Q-a placed on 1, 2 "
                         "and 4 cards, fig15, the sharded closed loop, the "
                         "(2, 2) train step)")
    ap.add_argument("--tree", type=Path,
                    help="with --only: drive the repro_torch package of "
                         "this checkout (e.g. a parent commit unpacked with "
                         "git archive) instead of this script's own")
    args = ap.parse_args()
    if args.tree is not None and args.only is None:
        fail("--tree needs --only")

    root = (args.tree.resolve() if args.tree is not None
            else Path(__file__).resolve().parent)
    if not (root / "src" / "repro_torch" / "device.py").is_file():
        fail("run from the root of a checkout: src/repro_torch is missing")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    if args.only == "cards" and torch.cuda.device_count() < CARDS:
        fail(f"--only cards needs {CARDS} cards, and "
             f"{torch.cuda.device_count()} are visible")
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
    print(f"cuts: {LM_ARCH} at {LM_LAYERS} of 32 layers (full width; "
          f"deepseek-v2-lite-16b and mamba2-370m uncut), in "
          f"bfloat16 where the reference defaults to float32, random "
          f"weights from --seed {args.seed}; prompts of {PREFILL_BATCH} x "
          f"{PREFILL_LEN} tokens (prefill) and {SERVE_REQUESTS} requests of "
          f"{SERVE_PROMPT} + {SERVE_NEW} new tokens (serving); training "
          f"(phase 8): {LM_ARCH} at {TRAIN_LAYERS} of 32 layers (full "
          f"width), float32 and then bf16, random weights, {TRAIN_STEPS} + "
          f"1 AdamW steps (lr {TRAIN_LR}) of {PREFILL_BATCH} x {PREFILL_LEN} "
          f"tokens on the pipeline's first batch repeated, recomputation "
          f"per period (the reference's default policy)", flush=True)
    t0 = time.perf_counter()
    libs = ("segment_join", "multikey_sort", "flash_attention",
            "flash_attention_sm90", "flash_attention_bwd",
            "flash_attention_bwd_bf16", "moe_dispatch")
    if args.only in ("moe-dispatch", "moe-layer"):
        libs = ("moe_dispatch",)
    elif args.only in ("join-build", "join-probe", "segment-sum", "sharded"):
        libs = ("segment_join",)
    elif args.only == "pressure":
        libs = ("segment_join", "multikey_sort")
    elif args.only in ("dryrun", "cards"):
        libs = ("flash_attention", "flash_attention_bwd", "moe_dispatch")
    for lib in libs:  # the first call builds every source, in parallel
        D.kernel_library(lib)
    print(f"kernel build ({', '.join(f'{x}.cu' for x in libs)}): "
          f"{time.perf_counter() - t0:.2f} s (nvcc {D.build_seconds():.2f} s)",
          flush=True)
    dev = torch.device("cuda")
    # float32 matmuls in full precision for the card/CPU comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only == "lm":
        res = {"models": lm_phase(args.seed, args.profile)[0]}
    elif args.only == "train":
        res = train_calls(dev, args.seed, args.profile)
    elif args.only == "sharded":
        res = sharded_calls(dev, args.seed, args.profile)
    elif args.only == "dryrun":
        res = {"mesh": mesh_phase(args.seed, root)[0]}
    elif args.only == "cards":
        res = cards_calls(args.seed, root)
    elif args.only is not None:
        res = ONLY[args.only](dev, args.seed)
    if args.only is not None:
        print(json.dumps({"only": args.only, "tree": str(root), **res}))
        print(card_line)
        return

    t0 = time.perf_counter()
    orders, lineitem = tpch(1.0, args.seed)
    want = oracle(orders, lineitem)
    print(f"data: {len(orders['orderkey'])} orders, "
          f"{len(lineitem['orderkey'])} lineitems, Q-b rows "
          f"{len(want['Q-b']['orderkey'])}, Q-c groups "
          f"{len(want['Q-c']['l_suppkey'])}, Q-d rows "
          f"{len(want['Q-d']['orderkey'])}, Q-e groups "
          f"{len(want['Q-e']['l_returnflag_linestatus'])} (rows "
          f"{[int(c) for c in want['Q-e']['count_orderkey']]}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # phase 2: kernels against their plain versions
    rows = kernel_phase(orders, lineitem, dev)
    rows.append(sort_kernel_phase(orders, dev))
    lm_rows = lm_kernel_phase(dev, args.seed)
    train_rows = train_kernel_phase(dev, args.seed)
    for r in rows:
        r["at"] = "tpch-sf1"
    for r in rows + lm_rows + train_rows:
        print(f"kernel {r['name']} ({r['at']}): {r['ms']:.4f} ms (plain "
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
        profile_queries(orders, lineitem, want)

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

    # phase 4b: the memory-pressure path (the SF1 tables still built)
    pressure = pressure_phase(orders, lineitem, want, args.seed)

    # phase 5: card vs CPU at small scale
    small_agreement(args.seed)
    print("small-scale card/CPU agreement: ok", flush=True)

    # phase 5b: the sharded fragment over eight logical lanes (the SF1
    # tables still built)
    t0 = time.perf_counter()
    sharded = sharded_phase(orders, lineitem, want, args.seed, args.profile)
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s (single-device "
          f"Q-a warm p50 {report['Q-a']['warm_p50_s'] * 1e3:.3f} ms, "
          f"sharded {sharded['Q-a']['warm_p50_s'] * 1e3:.3f} ms)",
          flush=True)

    # phase 6: LM serving, on a card emptied of the relational phases
    del server
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm, lm_launches = lm_phase(args.seed, args.profile)
    print(f"LM serving phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 7: the smoke configs on the card and the CPU (float32)
    f32_launches = lm_agreement(args.seed)

    # phase 8: training at full width, on the card emptied of phase 6 and 7
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, train_launches = train_phase(args.seed, args.profile)
    print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 9: the one-card mesh and the production dry-run
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh, _ = mesh_phase(args.seed, root)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)

    for r in rows:
        r["launches"] = launches[r["name"]]
    for r in lm_rows:  # each row's launches from its model's run
        r["launches"] = (f32_launches if r["name"] == "flash_attention_f32"
                         else lm_launches[r["at"]])[r["name"]]
    train_row_launches(train_rows, train_launches)
    rows += lm_rows + train_rows
    for r in rows:
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} was not launched on the main path "
                 f"({r['at']})")
    keys = ("name", "at", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extras = {f"{r['name']}@{r['at']}": {k: v for k, v in r.items()
                                          if k not in keys}
              for r in rows}
    print(json.dumps({"queries": {k: report[k] for k in QUERIES},
                      "peak_allocated_bytes": report["peak_allocated_bytes"],
                      "serving": serving, "pressure": pressure,
                      "sharded": sharded, "lm": lm,
                      "train": train, "mesh": mesh,
                      "kernel_rows": extras}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
