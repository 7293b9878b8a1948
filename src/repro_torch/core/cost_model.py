"""Regime-shift cost model (paper §VI).

    T_rel(N)    = O(N) + α(N, M)
    T_tensor(N) ≈ O(N)

α(N, M) is the spill-amplification term: once the linearized intermediate
(hash table / sort working set) exceeds the memory budget M, the operator
repartitions and re-materializes data through temp files.  Both the number of
partitioning/merge passes and the re-materialized volume grow with the memory
deficit W/M, making α superlinear in it.

The constants (seconds/row, seconds/byte of temp I/O) are host-dependent; the
model ships with conservative defaults and a ``calibrate()`` routine that fits
them from micro-runs of both engines — mirroring how the paper's selector uses
"indicators that are relatively easy to observe at the time of execution"
rather than a full optimizer-grade cost model.

These estimates price *execution*.  Under a :class:`~repro_torch.core.
resource_broker.ResourceBroker` the selector additionally folds the broker's
**queue-wait terms** (expected memory-admission wait onto T_rel, expected
device-queue wait onto T_tensor) on top of the feedback-blended estimates —
current load is a property of this instant's queues, not a cost to learn,
which is why it is added after the blend and never recorded into the profile
(see ``docs/costing.md``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .linear_engine import MAX_FANOUT, MERGE_BUFFER_BYTES, table_bytes_estimate

__all__ = ["CostConstants", "CostModel", "FragmentEstimate"]


@dataclasses.dataclass
class CostConstants:
    """Host-dependent constants; defaults retuned from micro-runs of
    the *actual* engines on the development host, not the seed's estimates.
    The seed constants described a hypothetical fast linear path (20 ns/row,
    1.2 ns/B of temp I/O) that underestimated the real spilling engine ~30x —
    the direct cause of the N=50k selector regret.  ``calibrate()`` refits
    everything here; the runtime feedback profile corrects residual drift."""

    # CPU work per row (seconds/row)
    linear_row_cost: float = 1.8e-7
    tensor_row_cost: float = 2.5e-7  # per-operator device-resident path
    # temp-file I/O cost (seconds/byte, counts write+read).  Dominated by the
    # partition/merge bookkeeping around the I/O, not raw disk bandwidth.
    io_byte_cost: float = 2.0e-8
    # fixed dispatch overhead of launching one tensor-path operator
    tensor_fixed_cost: float = 1.5e-3
    # -- v2: fused device-resident fragment terms ---------------------------
    # ONE dispatch for a whole Join→[Filter]→[Sort]→[Aggregate] fragment:
    # fusion amortizes the fixed cost across its operators
    fused_fixed_cost: float = 8.0e-4
    fused_row_cost: float = 2.0e-7   # per row through the fused program
    # each device→host synchronization (blocking scalar read / result fetch)
    host_sync_cost: float = 5.0e-5
    # host→device transfer (seconds/byte); multiplied by the *pending* upload
    # bytes — zero for base tables already resident in the device cache
    h2d_byte_cost: float = 1.0e-10
    # -- v7: sharded (partition-parallel) fragment terms --------------------
    # per-lane dispatch overhead of a gang launch, as a fraction of
    # fused_fixed_cost per mesh device
    shard_lane_cost: float = 0.15
    # per-row discount of partition-resident work: each partition's run
    # fits a cache level the monolithic working set overflows
    shard_residency_discount: float = 0.75
    # -- v8: spill-tier terms (the priced staircase) ------------------------
    # seconds/byte through the compressed host-RAM tier (T0): a codec pass
    # (dict-encode + bit-pack), not an fsync — an order of magnitude under
    # io_byte_cost
    t0_byte_cost: float = 1.5e-9
    # seconds/byte through the emulated remote tier (T1): bandwidth-capped
    # transfer + amortized latency; overridden per-quote by the hierarchy's
    # configured service model when one is attached
    t1_byte_cost: float = 6.0e-9
    # fraction of T1/T2 *re-read* latency hidden by the async T2→T0
    # prefetcher (build partitions stream back up while the probe side is
    # still being consumed)
    tier_prefetch_overlap: float = 0.5
    # -- v9: execution-time guard terms (mid-query re-planning) -------------
    # relative drift an ExecutionGuard tolerates before it even considers
    # switching: observed wall / spill may exceed the decision's estimate by
    # this fraction without firing.  Wide enough that ordinary estimate
    # noise (the runtime profile's own residual) stays inside the band.
    guard_band: float = 0.35
    # margin the priced tensor takeover must win by before a SwitchPoint is
    # taken: switch only when t_switch * guard_hysteresis < t_remaining.
    # >1 makes a borderline operator stay put — combined with the guard's
    # fire-once disarm, the decision can never flip twice.
    guard_hysteresis: float = 1.25
    # fixed overhead of abandoning a linear operator mid-query (tearing
    # down its partial state, re-entering the executor's tensor path)
    switch_fixed_cost: float = 2.0e-3


@dataclasses.dataclass
class JoinEstimate:
    path_fits_mem: bool
    spill_bytes: int
    passes: int
    t_linear: float
    t_tensor: float


@dataclasses.dataclass
class SortEstimate:
    path_fits_mem: bool
    spill_bytes: int
    passes: int
    t_linear: float
    t_tensor: float


@dataclasses.dataclass
class FragmentEstimate:
    """Plan-level estimate for a Join→[Filter]→[Sort]→[Aggregate] fragment."""

    path_fits_mem: bool   # whole linear fragment (join AND sort) avoids spill
    spill_bytes: int      # total predicted temp bytes across the fragment
    passes: int
    t_linear: float
    t_tensor: float       # the FUSED device-resident pipeline
    # pending host→device bytes charged to the tensor path — PHYSICAL bytes:
    # under packed device layouts (core/codec_device) the caller's
    # pending_upload_bytes/pending_partition_bytes price codes +
    # dictionaries, so a compressible table makes the tensor candidate
    # cheaper by exactly the bytes the bus is spared
    h2d_bytes: int
    # the partition-parallel fused pipeline over device_count mesh lanes
    # (inf when the fragment is not sharded-eligible or device_count <= 1)
    t_tensor_sharded: float = math.inf
    # the linear fragment with its spill routed through the tier staircase
    # (T0 compressed RAM → T1 emulated remote → T2 disk) instead of the
    # all-disk cliff (inf when no tier hierarchy is configured)
    t_linear_tiered: float = math.inf


class CostModel:
    def __init__(self, constants: Optional[CostConstants] = None):
        self.c = constants or CostConstants()

    # -- linearized-intermediate footprints ---------------------------------
    # One source of truth for "how much memory will this linear operator
    # actually need": the executor sizes its grant requests with these, and
    # the ResourceBroker prices admission (grant + expected wait) against
    # the SAME numbers — a quote probed with a different footprint than the
    # grant request would price the linear path against a queue it will
    # never stand in.

    @staticmethod
    def hash_need_bytes(n_rows: int) -> int:
        """Open-addressing hash-table footprint for an n-row build side
        (also the group-table footprint for n distinct groups)."""
        return table_bytes_estimate(n_rows)

    @staticmethod
    def sort_need_bytes(n_rows: int, row_bytes: int) -> int:
        """External-sort working set: input + run buffers ≈ 2× data."""
        return 2 * max(1, int(n_rows)) * max(1, int(row_bytes))

    # -- α(N, M) -------------------------------------------------------------
    def join_spill_bytes(self, n_build: int, n_probe: int, row_bytes_b: int,
                         row_bytes_p: int, work_mem: int) -> tuple:
        """Grace-join spill volume: every partitioning level rewrites both inputs."""
        table = table_bytes_estimate(n_build)
        if table <= work_mem:
            return 0, 0
        fanout = min(MAX_FANOUT, max(2, 2 ** math.ceil(math.log2(table / work_mem))))
        depth = max(1, math.ceil(math.log(table / work_mem, fanout)))
        data = n_build * row_bytes_b + n_probe * row_bytes_p
        written = data * depth
        return int(written), depth

    def sort_spill_bytes(self, n_rows: int, row_bytes: int, work_mem: int) -> tuple:
        """External-sort spill: initial runs + one full rewrite per merge pass."""
        data = n_rows * row_bytes
        if data <= work_mem:
            return 0, 0
        runs = math.ceil(data / work_mem)
        fan_in = max(2, work_mem // MERGE_BUFFER_BYTES - 1)
        merge_passes = max(0, math.ceil(math.log(runs, fan_in)))
        written = data * (1 + max(0, merge_passes - 1))  # final pass streams out
        return int(written), merge_passes

    def alpha(self, spill_bytes: int) -> float:
        # write + read back: 2x the written volume crosses the I/O boundary
        return self.c.io_byte_cost * 2 * spill_bytes

    def alpha_tiered(self, spill_bytes: int, tier_quotas=None,
                     tier_byte_s=None) -> float:
        """α with the spill volume routed through the tier staircase.

        Fills the predicted volume through (T0, T1, T2) in order: each tier
        absorbs up to its quota at its per-byte service time, the disk tier
        is the unbounded backstop.  ``tier_quotas``/``tier_byte_s`` are the
        (t0, t1, t2) tuples a tiered :class:`~repro_torch.core.resource_broker.
        PressureQuote` carries; missing entries fall back to the model's
        ``t0_byte_cost``/``t1_byte_cost``/``io_byte_cost`` constants.  The
        prefetcher hides ``tier_prefetch_overlap`` of the *re-read* half on
        the I/O tiers (T1/T2); the T0 re-read is a decode, nothing to hide.
        """
        quotas = list(tier_quotas) if tier_quotas is not None else [None, None, None]
        quotas += [None] * (3 - len(quotas))
        costs = list(tier_byte_s) if tier_byte_s is not None else [None, None, None]
        costs += [None] * (3 - len(costs))
        defaults = (self.c.t0_byte_cost, self.c.t1_byte_cost,
                    self.c.io_byte_cost)
        overlap = min(1.0, max(0.0, self.c.tier_prefetch_overlap))
        remaining = max(0, int(spill_bytes))
        t = 0.0
        for i in range(3):
            if remaining <= 0:
                break
            cap = quotas[i]
            take = remaining if (cap is None or i == 2) else min(remaining, int(cap))
            cost = costs[i] if costs[i] is not None else defaults[i]
            # write + read, with the prefetcher discounting I/O-tier re-reads
            read_factor = 1.0 if i == 0 else (1.0 - overlap)
            t += take * cost * (1.0 + read_factor)
            remaining -= take
        return t

    # -- operator estimates ------------------------------------------------
    def estimate_join(self, n_build: int, n_probe: int, row_bytes_b: int,
                      row_bytes_p: int, est_out: int, work_mem: int) -> JoinEstimate:
        n = n_build + n_probe
        spill, passes = self.join_spill_bytes(
            n_build, n_probe, row_bytes_b, row_bytes_p, work_mem)
        t_linear = self.c.linear_row_cost * (n + est_out) + self.alpha(spill)
        logn = max(1.0, math.log2(max(2, n_build)))
        t_tensor = (self.c.tensor_fixed_cost
                    + self.c.tensor_row_cost * (n_build * logn / 20 + n_probe + est_out))
        return JoinEstimate(spill == 0, spill, passes, t_linear, t_tensor)

    def estimate_sort(self, n_rows: int, row_bytes: int, num_keys: int,
                      work_mem: int) -> SortEstimate:
        spill, passes = self.sort_spill_bytes(n_rows, row_bytes, work_mem)
        logn = max(1.0, math.log2(max(2, n_rows)))
        t_linear = self.c.linear_row_cost * n_rows * logn / 4 + self.alpha(spill)
        t_tensor = (self.c.tensor_fixed_cost
                    + self.c.tensor_row_cost * n_rows * logn / 16 * num_keys)
        return SortEstimate(spill == 0, spill, passes, t_linear, t_tensor)

    def estimate_fragment(self, n_build: int, n_probe: int, row_bytes_b: int,
                          row_bytes_p: int, est_out: int, work_mem: int,
                          num_sort_keys: int = 0, has_filter: bool = False,
                          has_agg: bool = False, h2d_bytes: int = 0,
                          filter_selectivity: float = 1.0,
                          device_count: int = 1,
                          partition_skew: float = 1.0,
                          sharded_h2d_bytes: int = 0,
                          tier_quotas=None,
                          tier_byte_s=None) -> FragmentEstimate:
        """Cost a whole fusable fragment instead of its operators in isolation.

        The linear side is the sum of its per-operator costs (join + sort over
        the join output + filter/aggregate scans), each with its own spill
        term.  The tensor side is the FUSED pipeline: ``fused_fixed_cost`` is
        paid once for the entire fragment (fusion amortizes dispatch overhead
        across operators), exactly one host sync is charged, and H2D transfer
        is an explicit term over the *pending* upload bytes — zero when the
        base tables are already device-resident.

        ``filter_selectivity`` (an IR-only observable: the selector samples
        introspectable ``Expr`` predicates, something opaque lambdas never
        allowed) shrinks the rows the LINEAR side sorts/aggregates *after*
        its filter.  The fused tensor side is unaffected by design — its
        shapes are static capacity buckets, filtered rows are masked, not
        removed — which is exactly why a selective filter tilts the
        comparison toward the linear path at small scale.
        """
        join_spill, passes = self.join_spill_bytes(
            n_build, n_probe, row_bytes_b, row_bytes_p, work_mem)
        t_lin = (self.c.linear_row_cost * (n_build + n_probe + est_out)
                 + self.alpha(join_spill))
        spill = join_spill
        post_filter = est_out
        if has_filter:
            t_lin += self.c.linear_row_cost * est_out
            post_filter = int(est_out * min(1.0, max(0.0, filter_selectivity)))
        logo = max(1.0, math.log2(max(2, post_filter)))
        if num_sort_keys:
            out_row_bytes = row_bytes_b + row_bytes_p
            s_spill, s_passes = self.sort_spill_bytes(
                post_filter, out_row_bytes, work_mem)
            t_lin += (self.c.linear_row_cost * post_filter * logo / 4
                      + self.alpha(s_spill))
            spill += s_spill
            passes += s_passes
        if has_agg:
            t_lin += self.c.linear_row_cost * post_filter

        logb = max(1.0, math.log2(max(2, n_build)))
        logo_cap = max(1.0, math.log2(max(2, est_out)))  # static capacity
        rows = n_build * logb / 20 + n_probe + est_out
        if has_filter:
            rows += est_out
        if num_sort_keys:
            rows += est_out * logo_cap / 16 * num_sort_keys
        rows += est_out  # aggregate reduction / root materialization gather
        t_ten = (self.c.fused_fixed_cost + self.c.host_sync_cost
                 + self.c.h2d_byte_cost * h2d_bytes
                 + self.c.fused_row_cost * rows)

        # Sharded tensor path (aggregate roots only): the build-side
        # n·log n sort term DISAPPEARS — the partitioned layout caches
        # key-sorted runs, so per-query work is a searchsorted probe over
        # cache-resident partitions — and the remaining per-row work takes
        # the residency discount.  ``partition_skew`` (max/mean partition
        # fill) inflates the expansion/aggregate terms: the padded
        # capacity, and on a real mesh the critical path, follow the
        # fullest partition.  A sort stage costs nothing here (the
        # supported aggregates are order-independent; the per-shard
        # program skips it).  The gang launch pays a per-lane slice of
        # fixed cost on top of the fused dispatch.
        t_sh = math.inf
        if device_count > 1 and has_agg:
            skew = max(1.0, float(partition_skew))
            disc = self.c.shard_residency_discount
            rows_sh = n_build / 4  # residual touch of the cached runs
            rows_sh += (n_probe + est_out * skew) * disc
            if has_filter:
                rows_sh += est_out * skew * disc
            rows_sh += est_out * disc  # aggregate reduction
            t_sh = (self.c.fused_fixed_cost
                    * (1 + self.c.shard_lane_cost * device_count)
                    + self.c.host_sync_cost
                    + self.c.h2d_byte_cost * sharded_h2d_bytes
                    + self.c.fused_row_cost * rows_sh)
        # Tiered-linear: same CPU work, but the spill volume crosses the
        # tier staircase instead of the all-disk cliff.  α is linear in
        # bytes, so subtracting the fragment's combined disk α and adding
        # the staircase α over the combined volume re-prices exactly the
        # I/O term (the staircase is priced over the fragment's total spill
        # because its operators share one grant's quotas).
        t_tiered = math.inf
        if tier_quotas is not None or tier_byte_s is not None:
            t_tiered = (t_lin - self.alpha(spill)
                        + self.alpha_tiered(spill, tier_quotas, tier_byte_s))
        return FragmentEstimate(spill == 0, int(spill), passes, t_lin, t_ten,
                                int(h2d_bytes), t_tensor_sharded=t_sh,
                                t_linear_tiered=t_tiered)

    # -- execution-time guard pricing ---------------------------------------
    def price_switch(self, rows_pending: int, pending_bytes: int,
                     pairs: int) -> tuple:
        """Price finishing a drifted linear operator vs. a tensor takeover.

        Called from an :class:`~repro_torch.core.guards.ExecutionGuard` checkpoint
        with *observed* remaining work: ``rows_pending`` rows across
        ``pairs`` still-spilled partition pairs occupying ``pending_bytes``
        of live temp space.  Returns ``(t_remaining_linear, t_switch)``.

        The linear remainder must at least read the pending bytes back and
        hash/probe the pending rows; partitions that recurse further pay
        more, so this is a *lower bound* on the linear side — conservative
        in exactly the safe direction (the guard under-fires, never
        over-fires).  The takeover concatenates every reused pair and runs
        ONE gang tensor join (partitions are key-disjoint, so the result
        is byte-identical to per-pair joins), so it pays the fixed switch
        cost, a single dispatch (+2 syncs), per-row tensor work, and the
        H2D transfer of the pending bytes — ``pairs`` does NOT multiply
        the dispatch cost; per-pair takeovers were priced out because
        their fixed cost rivals the linear loop's per-pair work.  The
        read-back is priced at the H2D rate alone: ``io_byte_cost`` is
        fitted on the partition pass (hash + scatter + bookkeeping per
        byte) and overprices a plain sequential spill read by an order
        of magnitude, which would make every takeover look unaffordable.
        """
        c = self.c
        t_rem = (c.linear_row_cost * max(0, int(rows_pending))
                 + c.io_byte_cost * max(0, int(pending_bytes)))
        t_switch = (c.switch_fixed_cost
                    + c.tensor_fixed_cost + 2 * c.host_sync_cost
                    + c.tensor_row_cost * max(0, int(rows_pending))
                    + c.h2d_byte_cost * max(0, int(pending_bytes)))
        return t_rem, t_switch

    # -- calibration -----------------------------------------------------------
    def calibrate(self, n: int = 200_000, seed: int = 0,
                  device="cuda") -> CostConstants:
        """Fit constants from micro-runs of both engines (paper: selector inputs
        are execution-time observables, not optimizer statistics).  Tensor
        runs go to ``device`` and are timed to completion
        (``torch.cuda.synchronize`` on a CUDA device)."""
        from ..device import resolve_device
        from .linear_engine import hash_join_linear, sort_linear
        from .relation import Relation
        from .tensor_engine import tensor_join, tensor_sort

        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        build = Relation({"k": rng.permutation(n).astype(np.int64),
                          "v": rng.integers(0, 1 << 30, n).astype(np.int64)})
        probe = Relation({"k": rng.integers(0, n, n).astype(np.int64),
                          "w": rng.integers(0, 1 << 30, n).astype(np.int64)})
        big_mem = 1 << 34
        _, m_lin = hash_join_linear(build, probe, "k", big_mem)
        # warm up (first-call costs), then measure
        tensor_join(build, probe, "k", device=dev)
        _, m_ten = tensor_join(build, probe, "k", device=dev)
        self.c.linear_row_cost = max(1e-9, m_lin.wall_s / (3 * n))
        logn = math.log2(n)
        self.c.tensor_row_cost = max(
            1e-9, (m_ten.wall_s - self.c.tensor_fixed_cost) / (n * logn / 20 + 2 * n))

        # io cost: spilled sort vs in-memory sort on identical data
        rel = Relation({"a": rng.integers(0, 1000, n).astype(np.int64),
                        "b": rng.integers(0, 1 << 40, n).astype(np.int64),
                        "p": rng.integers(0, 1 << 40, n).astype(np.int64)})
        _, m_mem = sort_linear(rel, ["a", "b"], big_mem)
        _, m_spill = sort_linear(rel, ["a", "b"], 1 << 20)
        io_bytes = m_spill.spill.bytes_written + m_spill.spill.bytes_read
        if io_bytes:
            self.c.io_byte_cost = max(
                1e-11, (m_spill.wall_s - m_mem.wall_s) / io_bytes)
        self._calibrate_fused(n, rng, dev)
        return self.c

    def _calibrate_fused(self, n: int, rng, dev) -> None:
        """Fit the v2 terms by micro-running the FUSED executor: one
        blocking scalar fetch for ``host_sync_cost``, a fresh column upload
        for ``h2d_byte_cost``, and warm fused-fragment runs at two scales to
        separate ``fused_fixed_cost`` from ``fused_row_cost``."""
        import time

        import torch

        from ..device import synchronize, to_host, upload
        from .fused import FusedSpec, run_fused
        from .relation import Relation

        val = torch.ones((), dtype=torch.float64, device=dev) + 0
        to_host([val])
        t0 = time.perf_counter()
        reps = 64
        for _ in range(reps):
            to_host([val])
        self.c.host_sync_cost = max(1e-7, (time.perf_counter() - t0) / reps)

        col = rng.integers(0, 1 << 40, max(n, 1 << 16)).astype(np.int64)
        best = math.inf
        for _ in range(3):
            fresh = col.copy()  # a new buffer cannot be device-cached
            t0 = time.perf_counter()
            upload(fresh, dev)
            synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        self.c.h2d_byte_cost = max(1e-13, best / col.nbytes)

        # warm fused Join→Sort→Aggregate fragments at two scales.  With the
        # fragment's row-work model r(m), two walls give two unknowns:
        #   wall(m) = fixed + sync + row_cost * r(m)
        spec = FusedSpec(join_key="k", filter_fn=None, sort_keys=("k",),
                         agg=("b_v", "sum"))

        def rows_model(m: int) -> float:
            logm = max(1.0, math.log2(max(2, m)))
            return m * logm / 20 + m + m + m * logm / 16 + m

        n_small = 4096
        walls = {}
        for m in (n_small, n):
            build = Relation({"k": rng.permutation(m).astype(np.int64),
                              "v": rng.integers(0, 1 << 30, m).astype(np.int64)})
            probe = Relation({"k": rng.integers(0, m, m).astype(np.int64),
                              "w": rng.integers(0, 1 << 30, m).astype(np.int64)})
            run_fused(spec, build, probe, device=dev)  # cold: first call
            best = math.inf
            for _ in range(3):
                _, metrics = run_fused(spec, build, probe, device=dev)
                best = min(best, metrics.wall_s)
            walls[m] = best
        d_rows = rows_model(n) - rows_model(n_small)
        if n > n_small and d_rows > 0:
            self.c.fused_row_cost = max(
                1e-10, (walls[n] - walls[n_small]) / d_rows)
        self.c.fused_fixed_cost = max(
            1e-5, walls[n_small] - self.c.fused_row_cost * rows_model(n_small)
            - self.c.host_sync_cost)
