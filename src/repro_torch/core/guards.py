"""Execution-time guards: re-check the path decision while it runs.

The ``PathSelector`` prices a plan once, before the first operator runs.
When the estimate that priced it was wrong — a skewed key the duplication
sketch never sampled, a grant squeezed below the quote, stale cost
constants — the query is locked onto the linear spill cliff for its whole
lifetime.  Graefe's robustness maps and Chang's decision-timing work both
argue the fix is not better one-shot estimates but *re-checkable*
decisions: observe the running operator and abandon it when reality
crosses a guard band.

``ExecutionGuard`` is that observer.  It is duck-type compatible with the
``PreemptToken`` protocol the linear operators already poll (``check()``
simply delegates to the wrapped token), and adds explicit *checkpoints*
that the Grace join and external sort call at depth-0 partition
boundaries — the only places where the operator's partial state is a
clean prefix (joined partitions + still-spilled pairs) rather than a
half-built hash table.  At a checkpoint the guard compares elapsed wall
and observed spill/fan-out against the decision's estimates; when drift
crosses the band *and* the priced cost of finishing linear exceeds the
priced cost of a tensor takeover by the hysteresis margin, it raises
:class:`SwitchPoint` carrying everything the executor needs to finish the
operator on the tensor path without losing work: the already-joined
partition results, the still-spilled partition pairs (readable through
the same ``SpillManager``/``TierManager``), and the operator's
``SpillAccount`` so reuse stays on the same byte books.

Like ``PreemptedError``, ``SwitchPoint`` is control flow, not a failure:
it deliberately does not subclass the repo's error taxonomy so retry and
fault-injection machinery never confuse a re-plan with a fault.

A guard fires at most once (``fired`` disarms it) and the takeover path
runs guard-free, so a borderline operator can never oscillate between
paths — the hysteresis margin makes the switch strictly profitable under
the model before it is taken at all.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Tuple

__all__ = ["SwitchPoint", "ExecutionGuard"]


class SwitchPoint(Exception):
    """Abandon a running linear operator and re-enter the tensor path.

    Raised only from an :class:`ExecutionGuard` checkpoint at a partition
    boundary, where partial state is a loss-free prefix.  Fields:

    ``done``
        Already-joined partition results (list of ``Relation``), in
        partition order.  Empty for sort switches.
    ``pending``
        Remaining work still on the spill device.  For joins: the
        ``(build_path, probe_path, n_build, n_probe)`` pairs written by
        the Grace partitioning pass (``None`` paths mark empty
        partitions).  For sorts: the run paths awaiting merge.
    ``spill``
        The operator's ``SpillAccount``; the executor reads/deletes the
        pending spill through it so the tier books stay balanced.
    ``schema_hint``
        ``(build_schema, probe_schema)`` for joins so an all-empty switch
        still produces a schema-correct result.
    ``rows_done``
        Output rows already produced by the linear prefix.
    ``elapsed_s``
        Wall seconds burned by the abandoned linear attempt up to the
        switch point (attributed to the *pre-switch* path, never the
        takeover path's profile cell).
    ``restart``
        True when the switch fired *mid-partition-pass*: there is no
        reusable prefix yet, ``pending`` holds the partial spill file
        paths to delete, and the executor re-runs the whole operator on
        the tensor path from the base relations (which hit the device
        column cache, so the restart pays no H2D for registered tables).
    """

    def __init__(self, reason: str, *, op: str, done: Optional[List] = None,
                 pending: Optional[Sequence] = None, spill=None,
                 schema_hint: Optional[Tuple] = None, rows_done: int = 0,
                 elapsed_s: float = 0.0, restart: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.op = op
        self.done = done if done is not None else []
        self.pending = list(pending) if pending is not None else []
        self.spill = spill
        self.schema_hint = schema_hint
        self.rows_done = rows_done
        self.elapsed_s = elapsed_s
        self.restart = restart


class ExecutionGuard:
    """Runtime re-check of one linear operator's path decision.

    Constructed by the executor (via ``PathSelector.make_guard``) around
    the estimates the decision was priced with; passed to the operator as
    its ``cancel`` token.  The operator keeps polling ``check()`` exactly
    as it polls a plain ``PreemptToken`` — preemption still works through
    the guard — and additionally calls the ``observe_*`` /
    ``checkpoint*`` hooks at partition boundaries.  All hooks are invoked
    through ``getattr`` duck-typing in the engine, so a bare
    ``PreemptToken`` (or ``None``) remains a valid cancel token.
    """

    def __init__(self, model, *, op: str, t_linear: float, t_tensor: float,
                 predicted_spill_bytes: int, rows_in: int,
                 token=None, enabled: bool = True, allow_restart: bool = True):
        self.model = model
        self.op = op
        self.t_linear = max(t_linear, 1e-9)
        self.t_tensor = max(t_tensor, 0.0)
        self.predicted_spill_bytes = int(predicted_spill_bytes)
        self.rows_in = int(rows_in)
        self.token = token
        self.enabled = enabled
        self.allow_restart = allow_restart
        self.fired = False
        self.checkpoints = 0      # all checkpoint calls (observability)
        self._pair_cps = 0        # pair-boundary checkpoints only
        self._sort_cps = 0        # merge-pass checkpoints only
        self.observed_fanout = 0
        self.observed_depth = 0
        self.start_s = time.perf_counter()
        # elapsed at the first depth-0 boundary (end of the partition /
        # run-formation pass): observed throughput is measured from here
        self._pairs_t0: Optional[float] = None
        self._first_runs = 0  # run count at the first merge boundary
        # elapsed at the first *intra-pass* checkpoint (start of the
        # partition / run-formation write loop)
        self._part_t0: Optional[float] = None

    # -- PreemptToken protocol -------------------------------------------
    def check(self) -> None:
        if self.token is not None:
            self.token.check()

    # -- observations -----------------------------------------------------
    def observe_fanout(self, est_bytes: int, fanout: int, depth: int) -> None:
        """Record the partition geometry the Grace join actually chose."""
        self.observed_fanout = max(self.observed_fanout, int(fanout))
        self.observed_depth = max(self.observed_depth, int(depth) + 1)

    def elapsed(self) -> float:
        return time.perf_counter() - self.start_s

    def _armed(self) -> bool:
        return self.enabled and not self.fired and self.model is not None

    def _drift_ratio(self) -> float:
        """How much slower reality is than the decision's estimate.

        The guard's whole premise is that the model that priced the plan
        was wrong — so re-quoting the remaining linear work with the same
        constants would be wrong by the same factor and the hysteresis
        check could never clear.  The observed wall-vs-estimate ratio is
        the one piece of ground truth the guard owns; scaling the
        remaining-linear quote by it turns ``price_switch`` into an
        observation-corrected comparison (tensor constants are measured
        on-device by calibration and stay trusted as-is).
        """
        return max(1.0, self.elapsed() / self.t_linear)

    def _drifted(self, spill) -> Tuple[bool, str]:
        """Has observed execution left the decision's guard band?"""
        c = self.model.c
        band = 1.0 + c.guard_band
        elapsed = self.elapsed()
        if elapsed > self.t_linear * band:
            return True, (f"wall {elapsed * 1e3:.0f}ms > "
                          f"est {self.t_linear * 1e3:.0f}ms x{band:.2f}")
        written = int(getattr(spill, "bytes_written", 0))
        if written > max(self.predicted_spill_bytes, 1) * band:
            return True, (f"spill {written >> 10}KiB > "
                          f"est {self.predicted_spill_bytes >> 10}KiB x{band:.2f}")
        if self.predicted_spill_bytes == 0 and written > 0:
            return True, f"unpredicted spill {written >> 10}KiB"
        return False, ""

    # -- checkpoints ------------------------------------------------------
    def checkpoint(self, *, done, pending, spill, schema_hint=None) -> None:
        """Grace-join depth-0 partition boundary.

        ``done`` holds the partition results joined so far; ``pending``
        the spilled pairs not yet processed.  Raises :class:`SwitchPoint`
        when drift has crossed the band and the priced takeover wins by
        the hysteresis margin.
        """
        self.checkpoints += 1
        self._pair_cps += 1
        elapsed = self.elapsed()
        if self._pairs_t0 is None:
            self._pairs_t0 = elapsed
        if not self._armed():
            return
        drifted, why = self._drifted(spill)
        if not drifted:
            return
        rows_pending = sum(int(nb) + int(np_) for _b, _p, nb, np_ in pending
                           if _b is not None and _p is not None)
        pairs = sum(1 for _b, _p, nb, np_ in pending
                    if _b is not None and _p is not None)
        live = int(getattr(spill, "live_bytes", 0))
        t_rem, t_switch = self.model.price_switch(
            rows_pending=rows_pending, pending_bytes=live, pairs=pairs)
        t_rem *= self._drift_ratio()
        # once at least one pair has been processed the guard owns a
        # direct throughput measurement; it beats any model quote scaled
        # by whatever the stale constants got wrong (empty partitions are
        # counted on both sides, so the per-pair rate stays unbiased)
        done_pairs = self._pair_cps - 1
        if done_pairs >= 1:
            per_pair = (elapsed - self._pairs_t0) / done_pairs
            t_rem = max(t_rem, per_pair * len(pending))
        if t_switch * self.model.c.guard_hysteresis >= t_rem:
            return
        self.fired = True
        rows_done = sum(len(r) for r in done)
        raise SwitchPoint(
            f"guard: {why}; finish-linear {t_rem * 1e3:.0f}ms > "
            f"switch {t_switch * 1e3:.0f}ms",
            op=self.op, done=list(done), pending=pending, spill=spill,
            schema_hint=schema_hint, rows_done=rows_done,
            elapsed_s=self.elapsed())

    def checkpoint_partition(self, *, rows_done, rows_total, files,
                             spill) -> None:
        """Intra-pass checkpoint inside the partition / run-formation loop.

        By the first pair boundary the whole partitioning pass is sunk
        cost; when the decision was badly mispriced the profitable moment
        to abandon is *during* that pass.  There is no reusable prefix
        mid-pass, so a fire here is a ``restart``: the executor deletes
        the partial spill ``files`` and re-runs the operator on the
        tensor path from the base relations.  Pricing is observation-led:
        the measured write-loop throughput extrapolates the rest of the
        pass, and the follow-on phase (probe / merge) re-reads every byte
        and does the real work on top, so it is floored at one more full
        pass equivalent.  The model quote, drift-corrected, is kept as a
        second floor.
        """
        self.checkpoints += 1
        elapsed = self.elapsed()
        if self._part_t0 is None:
            self._part_t0 = elapsed
        if not self._armed() or not self.allow_restart:
            return
        if rows_done <= 0 or rows_total <= 0:
            return
        drifted, why = self._drifted(spill)
        if not drifted:
            return
        t_rem, t_switch = self.model.price_switch(
            rows_pending=rows_total, pending_bytes=0, pairs=0)
        t_rem *= self._drift_ratio()
        span = elapsed - self._part_t0
        if span > 0:
            per_row = span / rows_done
            t_rem = max(t_rem, per_row * (rows_total - rows_done)
                        + per_row * rows_total)
        if t_switch * self.model.c.guard_hysteresis >= t_rem:
            return
        self.fired = True
        raise SwitchPoint(
            f"guard: {why}; finish-linear {t_rem * 1e3:.0f}ms > "
            f"restart {t_switch * 1e3:.0f}ms",
            op=self.op, done=None, pending=files, spill=spill,
            elapsed_s=self.elapsed(), restart=True)

    def checkpoint_sort(self, *, pending, spill) -> None:
        """External-sort merge-pass boundary.

        Sort has no reusable partial order across paths, so a fired guard
        abandons the runs outright: ``pending`` carries the still-live
        run paths for the executor to delete (balancing the spill books)
        before the tensor sort re-runs from the base relation.
        """
        self.checkpoints += 1
        self._sort_cps += 1
        elapsed = self.elapsed()
        runs = len(pending)
        if self._pairs_t0 is None:
            self._pairs_t0 = elapsed
            self._first_runs = runs
        if not self._armed():
            return
        drifted, why = self._drifted(spill)
        if not drifted:
            return
        live = int(getattr(spill, "live_bytes", 0))
        t_rem, t_switch = self.model.price_switch(
            rows_pending=self.rows_in, pending_bytes=live, pairs=0)
        t_rem *= self._drift_ratio()
        # after one full merge pass the guard has a measured per-pass cost
        # and an observed run-shrink factor; remaining passes follow from
        # the run count still on disk (every pass touches all bytes, so
        # per-pass cost is stable across passes)
        passes_done = self._sort_cps - 1
        if passes_done >= 1 and runs > 1 and self._first_runs > runs:
            per_pass = (elapsed - self._pairs_t0) / passes_done
            shrink = max(2.0,
                         (self._first_runs / runs) ** (1.0 / passes_done))
            rem_passes = math.ceil(math.log(runs) / math.log(shrink))
            t_rem = max(t_rem, per_pass * max(1, rem_passes))
        if t_switch * self.model.c.guard_hysteresis >= t_rem:
            return
        self.fired = True
        raise SwitchPoint(
            f"guard: {why}; finish-linear {t_rem * 1e3:.0f}ms > "
            f"switch {t_switch * 1e3:.0f}ms",
            op=self.op, done=None, pending=pending, spill=spill,
            elapsed_s=self.elapsed())

    def observe_fragment(self, total: int, capacity: int) -> None:
        """Fused-fragment capacity overflow: observed join fan-out.

        The fused path's optimistic capacity bucket is itself an estimate;
        an overflow is the device telling us the actual fan-out.  The
        guard records it and — only when the priced linear fragment beats
        the cost of re-running the fused program at the exact bucket by
        the hysteresis margin — abandons the retry loop so the executor's
        generic walk re-prices with ground truth.  In practice the retry
        almost always wins (the observation is still recorded for the
        profile); the escape hatch exists for the pathological corner.
        """
        self.observed_fanout = max(self.observed_fanout,
                                   int(total) // max(1, int(capacity)) + 1)
        if not self._armed():
            return
        c = self.model.c
        t_retry = (c.fused_fixed_cost + c.fused_row_cost * max(0, int(total))
                   + c.switch_fixed_cost)
        if self.t_linear * c.guard_hysteresis < t_retry:
            self.fired = True
            raise SwitchPoint(
                f"guard: fragment overflow total={total} capacity={capacity}; "
                f"retry {t_retry * 1e3:.1f}ms > linear "
                f"{self.t_linear * 1e3:.1f}ms", op="fused_pipeline",
                elapsed_s=self.elapsed())
