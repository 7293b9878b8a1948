"""SLO primitives for open-loop serving: tenant classes and arrival processes.

A copy of ``src/repro/core/slo.py`` (numpy only), so that the port imports
nothing of the reference package.

The closed loop (``QueryServer.serve``) holds offered concurrency
constant — each worker submits its next query only when the previous one
completes, so the system can never be offered more load than it is
finishing.  Production traffic does not cooperate like that: clients arrive
on their own clock (open loop), load comes in bursts, and a backlog *grows*
when service slows instead of throttling itself.  The difference is the
classic coordinated-omission trap: a closed loop under-reports exactly the
overload tails an open loop exposes.

:class:`ArrivalProcess` generates that traffic: a homogeneous Poisson
stream at ``rate_qps`` by default, or a piecewise-constant-rate process
(``phases``) for bursty storms — each arrival is an independent logical
client, so a storm of thousands of arrivals models thousands of clients
without thousands of threads.  Seeded and fully reproducible: the same seed
replays the same arrival schedule (the seed-discipline satellite fig13
records in its summary).

:class:`TenantClass` is the admission-control contract a stream of arrivals
runs under: a **deadline** (the SLO budget a query is worth serving
within), a **priority** (higher drains first from the ready queue, and may
preempt floor-degraded linear operators mid-spill), and **sheddability**
(whether admission may reject the query outright when its quoted wait
already exceeds the deadline — serving it would burn capacity on a result
nobody can use, the classic load-shedding argument).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["TenantClass", "ArrivalProcess"]


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant's SLO contract.

    ``deadline_s`` — the end-to-end (arrival → completion) budget; admission
    sheds a sheddable query whose quoted wait already exceeds it, and a
    served query is SLO-violating when its sojourn runs past it.
    ``priority`` — higher drains first from the ready queue; a positive
    priority additionally triggers preemption of floor-degraded linear
    operators when this tenant's admission would otherwise block.
    ``sheddable`` — False marks traffic that must always run (the premium
    contract): admission never rejects it and a missed deadline is recorded
    on the served sample (``slo_ok=False``), never converted into a
    rejection.
    """

    name: str
    deadline_s: float
    priority: int = 0
    sheddable: bool = True

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")


class ArrivalProcess:
    """Seeded open-loop arrival-time generator.

    With only ``rate_qps``: a homogeneous Poisson process (exponential
    inter-arrivals).  With ``phases`` — a sequence of ``(duration_s,
    rate_qps)`` segments, cycled for as long as arrivals are drawn — a
    piecewise-constant-rate process: the canonical bursty-traffic model
    (e.g. ``[(4, 2), (3, 60), (5, 2)]`` = calm, storm, cool-down).  A
    segment rate of 0 is a silent gap.

    :meth:`times` draws the arrival offsets over ``[0, duration_s)`` —
    every draw with the same seed yields the same schedule.
    """

    def __init__(self, rate_qps: float = 1.0,
                 phases: Optional[Sequence[Tuple[float, float]]] = None,
                 seed: int = 0):
        if phases is not None:
            phases = [(float(d), float(r)) for d, r in phases]
            if not phases:
                raise ValueError("phases must be non-empty when given")
            for d, r in phases:
                if d <= 0:
                    raise ValueError(f"phase duration must be positive, got {d}")
                if r < 0:
                    raise ValueError(f"phase rate must be >= 0, got {r}")
        elif rate_qps < 0:
            raise ValueError(f"rate_qps must be >= 0, got {rate_qps}")
        self.rate_qps = float(rate_qps)
        self.phases = phases
        self.seed = int(seed)

    def times(self, duration_s: float, max_n: int = 1_000_000) -> np.ndarray:
        """Sorted arrival offsets in ``[0, duration_s)``; deterministic for
        a given seed.  ``max_n`` is a runaway guard (a mis-set rate cannot
        OOM the harness), raising rather than silently truncating."""
        rng = np.random.default_rng(self.seed)
        phases = (list(self.phases) if self.phases is not None
                  else [(float(duration_s) or 1.0, self.rate_qps)])
        out = []
        seg_start = 0.0
        i = 0
        while seg_start < duration_s:
            dur, rate = phases[i % len(phases)]
            i += 1
            seg_end = min(float(duration_s), seg_start + dur)
            if rate > 0:
                t = seg_start
                while True:
                    t += rng.exponential(1.0 / rate)
                    if t >= seg_end:
                        break
                    out.append(t)
                    if len(out) > max_n:
                        raise ValueError(
                            f"arrival process exceeded max_n={max_n} "
                            f"arrivals before t={t:.1f}s; check the rate")
            seg_start = seg_end
        return np.asarray(out, dtype=np.float64)
