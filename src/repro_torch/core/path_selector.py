"""Execution-time path selection (paper §III.C), plan-level and feedback-driven.

The selector is *deliberately simple*: it looks only at indicators observable
cheaply at execution time — input scale, join-key cardinality, expected
intermediate size, and the memory budget — and asks one structural question:
**will the linear path's linearized intermediate exceed work_mem?**  If it
comfortably fits, the linear path wins (paper §V.B: at small scale the CPU
hash join is faster).  If it would spill, the regime-shift model predicts the
amplification cost α(N, M) and the tensor path is chosen when it avoids a
worse expected (and far worse tail) latency.

Two layers sit on top of the seed's per-operator, prediction-only
design:

  * **plan-level costing** — :meth:`choose_fragment` prices a whole
    ``Join→[Filter]→[Sort]→[Aggregate]`` fragment at once, so the fused
    pipeline's amortized fixed cost, single host sync, and (cache-aware) H2D
    transfer term compete against the *sum* of the linear operators, not
    against one join in isolation.  This is what removes the N=50k regret:
    per-operator costing charged the tensor path its fixed overhead three
    times and its H2D upload every query.
  * **runtime feedback** — every estimate is blended with the
    :class:`~repro_torch.core.runtime_profile.RuntimeProfile`'s observed wall
    times for the same ``(op, path, size-bucket)``, so the crossover point
    self-corrects on hosts where the shipped constants are stale.

**Queue-aware pricing**: when the executor runs under a
:class:`~repro_torch.core.resource_broker.ResourceBroker` it passes each decision
the broker's :class:`~repro_torch.core.resource_broker.PressureQuote`\\ s — the
expected memory grant *and* expected admission wait (charged to the linear
path) plus the expected device-queue wait (charged to the tensor path).
``auto`` therefore stops choosing a small linear operator that then parks
in admission while the tensor path would run immediately, and stops piling
onto a deeply-queued device when the linear path is free.  The wait terms
are folded AFTER the feedback blend and never recorded into the profile:
load is a property of this instant's queues, not an execution cost.

Key-cardinality sampling is served by the cached sketch in
:mod:`repro_torch.core.table_cache` — the seed re-ran a 65536-row ``np.unique``
on every ``choose_join`` call.

The selection never changes operator semantics — both paths produce identical
result sets (tests assert canonical equality).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from .cost_model import CostModel
from .device_relation import DeviceRelation
from .relation import Relation
from .runtime_profile import RuntimeProfile
from .table_cache import key_stats, pending_upload_bytes

__all__ = ["Decision", "PathSelector"]

# Guards the per-relation filter-selectivity memo (concurrent sessions
# share probe relations); the sampled evaluation itself runs unlocked.
_SEL_LOCK = threading.Lock()


@dataclasses.dataclass
class Decision:
    path: str  # "linear" | "tensor"
    reason: str
    t_linear: float
    t_tensor: float
    predicted_spill_bytes: int
    h2d_bytes: int = 0  # pending upload bytes charged to the tensor estimate
    # Broker queue-wait terms folded into t_linear / t_tensor (0 when the
    # decision was priced without quotes — ungoverned, or queue-blind):
    mem_wait_s: float = 0.0  # expected memory-admission wait (linear path)
    dev_wait_s: float = 0.0  # expected device-queue wait (tensor path)
    # Device lanes the chosen tensor path should fan out over: 1 for the
    # single-device fused program, N when the sharded partition-parallel
    # program priced cheaper (requires path == "tensor").
    shards: int = 1
    # True when the linear candidate that won (or lost) was the TIERED
    # variant: its spill priced through the T0/T1/T2 staircase instead of
    # the all-disk cliff (requires a tier hierarchy on the session; the
    # executor then routes the operator's spill through the TierManager).
    tiered: bool = False


class PathSelector:
    def __init__(self, work_mem: int, cost_model: Optional[CostModel] = None,
                 force: Optional[str] = None,
                 profile: Optional[RuntimeProfile] = None,
                 tiers=None, device="cuda"):
        self.work_mem = int(work_mem)
        # whose device cache pending uploads are priced against; the
        # executor that owns this selector sets it to its own device
        self.device = device
        self.model = cost_model or CostModel()
        if force not in (None, "linear", "tensor"):
            raise ValueError(force)
        self.force = force
        # Optional spill-tier hierarchy (a TierConfig): prices the
        # tiered-linear candidate even when a decision arrives without a
        # broker quote (ungoverned sessions).  Quotes from a tiered
        # governor carry fresher per-grant quotas and win when present.
        self.tiers = tiers
        # A fresh profile per selector by default: observations from one
        # query stream never leak into another's decisions.  Pass
        # runtime_profile.DEFAULT_PROFILE to share across executors.
        self.profile = RuntimeProfile() if profile is None else profile

    # -- broker quotes -------------------------------------------------------
    @staticmethod
    def _waits(mem_quote, dev_quote):
        """Queue-wait terms from the broker's quotes: expected memory-
        admission wait charges the LINEAR path (it is what the operator
        would stand in before its grant), expected device-queue wait
        charges the TENSOR path.  Folded AFTER the feedback blend — load is
        a property of this instant's queues, not an execution cost to
        learn."""
        mem_wait = 0.0 if mem_quote is None else float(mem_quote.expected_wait_s)
        dev_wait = 0.0 if dev_quote is None else float(dev_quote.expected_wait_s)
        return mem_wait, dev_wait

    def _resolve_wm(self, work_mem, mem_quote) -> int:
        """The work_mem this decision prices the linear path against: an
        explicit override wins, else the quote's expected grant (the
        governor's full-or-policy sizing), else the configured ceiling."""
        if work_mem is not None:
            return int(work_mem)
        if mem_quote is not None:
            return int(mem_quote.grant_bytes)
        return self.work_mem

    @staticmethod
    def _wait_note(mem_wait: float, dev_wait: float) -> str:
        if mem_wait < 1e-4 and dev_wait < 1e-4:
            return ""
        return (f"; queue-aware: +{mem_wait * 1e3:.0f}ms expected admission "
                f"wait on linear, +{dev_wait * 1e3:.0f}ms device queue on "
                f"tensor")

    # -- execution-time observables -----------------------------------------
    @staticmethod
    def _dup_estimate(build, key: str) -> float:
        """Key duplication factor from the cached cardinality sketch.

        A device-resident input is NOT sampled — pulling 64k keys to the
        host for planning would be exactly the regime-crossing round trip
        this layer exists to avoid; scale alone decides (dup ≈ 1).
        """
        if isinstance(build, DeviceRelation):
            return 1.0
        return key_stats(build, key).dup

    # -- execution-time guards ----------------------------------------------
    def make_guard(self, decision: Decision, op: str, rows_in: int,
                   token=None, enabled: bool = True):
        """An :class:`~repro_torch.core.guards.ExecutionGuard` re-checking this
        decision while the chosen linear operator runs.

        The selector owns re-decision policy for the same reason it owns the
        initial decision: the guard band, hysteresis margin, and switch
        pricing all come from the same :class:`CostModel` that priced the
        path in the first place, so a switch only fires when the model —
        fed *observed* drift instead of estimates — reverses its own
        verdict.  Forced decisions are never guarded (a forced path is the
        experiment's control, not a costed choice); neither are non-linear
        paths (the guard's escape hatch IS the tensor takeover).  Returns
        ``token`` unchanged when no guard applies, so the caller can pass
        the result straight through as the operator's cancel token.
        """
        if not enabled or self.force is not None or decision.path != "linear":
            return token
        from .guards import ExecutionGuard

        # the guard clocks execution wall AFTER admission; strip the folded
        # queue-wait term so drift is measured against execution cost only
        return ExecutionGuard(
            self.model, op=op,
            t_linear=max(0.0, decision.t_linear - decision.mem_wait_s),
            t_tensor=decision.t_tensor,
            predicted_spill_bytes=decision.predicted_spill_bytes,
            rows_in=rows_in, token=token)

    # -- join ---------------------------------------------------------------
    def choose_join(self, build: Relation, probe: Relation, key: str,
                    work_mem: Optional[int] = None,
                    mem_quote=None, dev_quote=None) -> Decision:
        """``work_mem`` overrides the selector's configured budget for THIS
        decision; under a shared governor the executor instead passes the
        broker's ``mem_quote`` (the grant a request would receive *right
        now* PLUS the expected admission wait) and ``dev_quote`` (expected
        device-queue wait), so contention shifts ``auto`` toward the tensor
        path both when the linear path would be squeezed into the spill
        regime AND when it would park in admission while the device is
        free."""
        if self.force:
            return Decision(self.force, "forced", 0.0, 0.0, 0)
        wm = self._resolve_wm(work_mem, mem_quote)
        mem_wait, dev_wait = self._waits(mem_quote, dev_quote)
        n_b, n_p = len(build), len(probe)
        dup = self._dup_estimate(build, key)
        est_out = int(n_p * dup)
        est = self.model.estimate_join(
            n_b, n_p, build.row_bytes(), probe.row_bytes(), est_out, wm)
        t_lin = self.profile.blend(est.t_linear, "hash_join", "linear",
                                   n_b + n_p) + mem_wait
        t_ten = self.profile.blend(est.t_tensor, "hash_join", "tensor",
                                   n_b + n_p) + dev_wait
        note = self._wait_note(mem_wait, dev_wait)
        if est.path_fits_mem and t_lin <= t_ten:
            return Decision(
                "linear",
                f"hash table fits work_mem ({wm} B); linear path has "
                f"no spill regime at this scale" + note,
                t_lin, t_ten, 0, mem_wait_s=mem_wait, dev_wait_s=dev_wait)
        path = "tensor" if t_ten < t_lin else "linear"
        return Decision(
            path,
            f"predicted spill {est.spill_bytes / 1e6:.1f} MB over {est.passes} "
            f"partition pass(es): α(N,M) makes T_linear={t_lin:.3f}s vs "
            f"T_tensor={t_ten:.3f}s (feedback-blended)" + note,
            t_lin, t_ten, est.spill_bytes,
            mem_wait_s=mem_wait, dev_wait_s=dev_wait)

    # -- sort ------------------------------------------------------------------
    def choose_sort(self, rel: Relation, keys,
                    work_mem: Optional[int] = None,
                    mem_quote=None, dev_quote=None) -> Decision:
        if self.force:
            return Decision(self.force, "forced", 0.0, 0.0, 0)
        wm = self._resolve_wm(work_mem, mem_quote)
        mem_wait, dev_wait = self._waits(mem_quote, dev_quote)
        est = self.model.estimate_sort(
            len(rel), rel.row_bytes(), len(keys), wm)
        t_lin = self.profile.blend(est.t_linear, "sort", "linear",
                                   len(rel)) + mem_wait
        t_ten = self.profile.blend(est.t_tensor, "sort", "tensor",
                                   len(rel)) + dev_wait
        note = self._wait_note(mem_wait, dev_wait)
        if est.path_fits_mem and t_lin <= t_ten:
            return Decision(
                "linear",
                "dataset fits work_mem; in-memory lexsort is cheapest" + note,
                t_lin, t_ten, 0, mem_wait_s=mem_wait, dev_wait_s=dev_wait)
        path = "tensor" if t_ten < t_lin else "linear"
        return Decision(
            path,
            f"predicted spill {est.spill_bytes / 1e6:.1f} MB / {est.passes} merge "
            f"pass(es); T_linear={t_lin:.3f}s vs T_tensor={t_ten:.3f}s" + note,
            t_lin, t_ten, est.spill_bytes,
            mem_wait_s=mem_wait, dev_wait_s=dev_wait)

    # -- fused fragment (plan-level) ----------------------------------------
    @staticmethod
    def _filter_selectivity(filter_fn, probe: Relation,
                            build=None) -> float:
        """Sampled selectivity of an introspectable (Expr) predicate.

        This is the observability the logical IR buys over opaque lambdas:
        when the predicate reads only probe-side columns, evaluating it over
        a small prefix sample predicts how many joined rows survive the
        fragment's filter — the linear path's sort/aggregate work shrinks
        accordingly.  Opaque callables (or build-side references, which
        would need the join) stay at selectivity 1.0."""
        from .expr import Expr
        from .relation import column_token

        if not isinstance(filter_fn, Expr) or not isinstance(probe, Relation):
            return 1.0  # opaque predicate, or device-resident input (no
            #             host sample without a regime-crossing fetch)
        cols = sorted(filter_fn.columns())
        if len(probe) == 0 or not (set(cols) <= set(probe.names)):
            return 1.0
        if build is not None and any(
                c.startswith("b_") and c[2:] in build.names for c in cols):
            # the join naming contract resolves this name to the BUILD side
            # (build wins collisions); the probe's same-named column is a
            # different column and would feed a wrong selectivity
            return 1.0
        # memoized like key_stats: warm serving queries must not pay a
        # per-query sample evaluation (entries shared with select() subs).
        # Same locking discipline as the other shared caches: the lock
        # guards the dict, the sample evaluation runs outside it
        tokens = tuple(column_token(probe[c]) for c in cols)
        tok = filter_fn.cache_token()
        with _SEL_LOCK:
            cache = probe.__dict__.setdefault("_sel_cache", {})
            hit = cache.get(tok)
            if hit is not None and hit[0] == tokens:
                return hit[1]
        # strided sample, not a prefix: tables sorted/clustered by the
        # filtered column (e.g. time-ordered facts filtered on recency)
        # would make a prefix systematically unrepresentative and pin the
        # selector on a mispriced path
        stride = max(1, len(probe) // 4096)
        sample = {c: probe[c][::stride] for c in cols}
        try:
            mask = np.asarray(filter_fn(sample), bool)
        except Exception:
            return 1.0
        sel = float(mask.mean()) if mask.ndim else 1.0
        with _SEL_LOCK:
            if len(cache) >= 64:
                cache.clear()  # tiny float entries; crude bound is enough
            cache[tok] = (tokens, sel)
        return sel

    def _sharded_candidate(self, spec, build, probe, max_shards: int):
        """``(shards, skew, pending_h2d)`` for the partition-parallel fused
        program, or ``(1, 1.0, 0)`` when it is not on the table: the caller
        did not opt in (``max_shards <= 1``), the mesh has a single device,
        an input is already device-resident (partitioning plans from host
        columns), or the fragment is outside the sharded path's bit-for-bit
        eligibility (:func:`repro_torch.core.fused.sharded_supported`).  Skew and
        the pending-transfer bytes come from the partition cache's memoized
        counts — pricing stays O(1) on warm serving paths."""
        # this package runs one device: the mesh has a single lane, which
        # is the reference's own answer on a one-device mesh
        return 1, 1.0, 0

    def choose_fragment(self, spec, build: Relation, probe: Relation,
                        work_mem: Optional[int] = None,
                        mem_quote=None, dev_quote=None,
                        max_shards: int = 1) -> Decision:
        """Price a whole fusable fragment: ONE fixed dispatch, ONE host sync,
        and H2D transfer only for base-table columns not already resident in
        the device cache (warm serving queries charge 0).  Fragments arrive
        from the rewrite planner, so this prices the REWRITTEN plan — pruned
        scans carry smaller row_bytes, pushed-down filters carry sampled
        selectivity.  ``work_mem`` overrides the configured budget;
        ``mem_quote``/``dev_quote`` (broker quotes) carry the governor's
        current-grant estimate plus the expected admission/device-queue
        waits (queue-aware pricing).

        ``max_shards > 1`` additionally prices the partition-parallel
        sharded program (when the fragment is eligible): its estimate
        carries the lane fan-out, the measured partition skew, and the
        partitioned layout's own pending-transfer bytes, and its queue term
        is the GANG wait — the max over the quote's per-lane expected waits,
        because a gang dispatch blocks on its slowest lane."""
        if self.force:
            return Decision(self.force, "forced", 0.0, 0.0, 0)
        import math

        from .tensor_engine import capacity_bucket

        wm = self._resolve_wm(work_mem, mem_quote)
        mem_wait, dev_wait = self._waits(mem_quote, dev_quote)
        n_b, n_p = len(build), len(probe)
        dup = self._dup_estimate(build, spec.join_key)
        est_out = int(n_p * dup)
        h2d = (pending_upload_bytes(build, capacity_bucket(n_b), self.device)
               + pending_upload_bytes(probe, capacity_bucket(n_p),
                                      self.device))
        shards, skew, sharded_h2d = self._sharded_candidate(
            spec, build, probe, max_shards)
        # tier staircase terms: a tiered governor's quote carries per-grant
        # quotas + per-byte service times; an ungoverned tiered session
        # derives them from the configured hierarchy
        tq = getattr(mem_quote, "tier_quotas", None)
        tbs = getattr(mem_quote, "tier_byte_s", None)
        if tq is None and self.tiers is not None:
            cap0 = int(self.tiers.t0_capacity)
            tq = (min(cap0, max(2 * wm, cap0 // 2)),
                  self.tiers.t1_capacity, None)
            tbs = self.tiers.byte_costs()
        est = self.model.estimate_fragment(
            n_b, n_p, build.row_bytes(), probe.row_bytes(), est_out,
            wm, num_sort_keys=len(spec.sort_keys),
            has_filter=spec.filter_fn is not None,
            has_agg=spec.agg is not None, h2d_bytes=h2d,
            filter_selectivity=self._filter_selectivity(spec.filter_fn,
                                                        probe, build),
            device_count=shards, partition_skew=skew,
            sharded_h2d_bytes=sharded_h2d,
            tier_quotas=tq, tier_byte_s=tbs)
        n = n_b + n_p
        t_lin = self.profile.blend(est.t_linear, "fragment", "linear",
                                   n) + mem_wait
        # Tiered-linear as a DISTINCT candidate with its own profile cell:
        # same CPU work, spill routed through the priced staircase.  It
        # competes against plain (disk-cliff) linear for the linear slot so
        # ``auto`` lands between the cliff and the tensor path.
        tiered = False
        if est.spill_bytes > 0 and math.isfinite(est.t_linear_tiered):
            t_tier = self.profile.blend(est.t_linear_tiered, "fragment",
                                        "linear_tiered", n) + mem_wait
            if t_tier < t_lin:
                note_tier = (f"; tiered-linear staircase priced "
                             f"{t_tier:.3f}s vs {t_lin:.3f}s disk-spill")
                t_lin, tiered = t_tier, True
            else:
                note_tier = ""
        else:
            note_tier = ""
        t_ten = self.profile.blend(est.t_tensor, "fragment", "tensor",
                                   n) + dev_wait
        t_sh, gang_wait = math.inf, 0.0
        if shards > 1 and math.isfinite(est.t_tensor_sharded):
            lane_waits = () if dev_quote is None else dev_quote.lane_waits
            gang_wait = max([lane_waits[i] if i < len(lane_waits) else 0.0
                             for i in range(shards)] + [dev_wait])
            t_sh = self.profile.blend(est.t_tensor_sharded, "fragment",
                                      "tensor_sharded", n) + gang_wait
        use_sharded = t_sh < t_ten
        t_dev = min(t_ten, t_sh)
        dec_shards = shards if use_sharded else 1
        note = self._wait_note(mem_wait, dev_wait) + note_tier
        if use_sharded:
            note += (f"; sharded over {shards} lanes priced "
                     f"{t_sh:.3f}s vs {t_ten:.3f}s single-device "
                     f"(partition skew {skew:.2f}, gang wait "
                     f"{gang_wait * 1e3:.0f}ms)")
        num_ops = 1 + (spec.filter_fn is not None) + bool(spec.sort_keys) \
            + (spec.agg is not None)
        if est.path_fits_mem and t_lin <= t_dev:
            return Decision(
                "linear",
                f"whole linear fragment fits work_mem ({wm} B) and "
                f"T_linear={t_lin:.3f}s <= T_tensor={t_dev:.3f}s" + note,
                t_lin, t_dev, 0, h2d,
                mem_wait_s=mem_wait, dev_wait_s=dev_wait, tiered=tiered)
        path = "tensor" if t_dev < t_lin else "linear"
        return Decision(
            path,
            f"fragment-level: T_linear={t_lin:.3f}s vs T_tensor={t_dev:.3f}s "
            f"(fixed cost amortized over {num_ops} fused ops, "
            f"{(sharded_h2d if use_sharded else h2d) / 1e6:.1f} MB pending "
            f"H2D, predicted spill "
            f"{est.spill_bytes / 1e6:.1f} MB, feedback-blended)" + note,
            t_lin, t_dev, est.spill_bytes,
            sharded_h2d if use_sharded else h2d,
            mem_wait_s=mem_wait, dev_wait_s=dev_wait,
            shards=dec_shards if path == "tensor" else 1,
            tiered=tiered if path == "linear" else False)
