"""Runtime feedback profile: observed wall times blended into cost predictions.

The cost model's constants are host-dependent: seconds/row on *this* CPU,
seconds/byte through *this* temp filesystem, dispatch overhead of *this*
device.  Shipped defaults are fit on one development machine and drift
everywhere else — which is exactly how plan choices that are optimal under
stale cost assumptions become brittle under actual run-time conditions
(Graefe's robustness maps; the ROADMAP's N=50k selector regret).

Instead of trusting plan-time constants forever, the :class:`Executor`
records what each ``(op, path, size-bucket)`` actually cost, and the
:class:`PathSelector` pulls its predictions toward those observations with a
confidence-weighted blend.  Two properties matter:

  * the crossover point **self-corrects on any host**: a mispredicted path
    gets observed as slow, its blended estimate rises, and the selector
    switches — without anyone re-running ``calibrate()``;
  * selection never changes operator semantics — both paths produce
    identical result sets; only the timing estimates adapt.

Observations are EWMA-smoothed per cell so a one-off stall (compile, GC,
page cache miss) cannot permanently poison a bucket, and bucketing by input
scale (one bucket per octave) keeps observations from one size regime from
leaking into another.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

__all__ = ["Observation", "RuntimeProfile", "size_bucket", "DEFAULT_PROFILE"]


def size_bucket(rows: int) -> int:
    """Log2 bucket of the input scale: one feedback cell per octave."""
    return max(1, int(rows)).bit_length()


@dataclasses.dataclass
class Observation:
    wall_s: float = 0.0  # EWMA of observed wall seconds
    count: int = 0
    warmups_seen: int = 0  # discarded warmup (likely-compiling) samples


class RuntimeProfile:
    """Observed ``(op, path, size-bucket) → wall_s`` feedback store.

    ``blend(predicted, ...)`` returns the prediction when a cell is cold and
    converges to the observed EWMA as evidence accumulates:
    ``w = count / (count + confidence)``.
    """

    def __init__(self, alpha: float = 0.35, confidence: int = 2):
        self.alpha = float(alpha)
        self.confidence = int(confidence)
        self._cells: Dict[Tuple[str, str, int], Observation] = {}
        self._lock = threading.Lock()

    def record(self, op: str, path: str, rows: int, wall_s: float,
               warmup_discard: bool = False) -> None:
        """Record one observation.  ``warmup_discard=True`` drops the FIRST
        sample a cold cell ever sees: callers pass it when the sample may
        include one-time jit compilation they cannot detect precisely (the
        per-operator tensor path), so a multi-second compile never enters
        the blend as a steady-state cost."""
        key = (op, path, size_bucket(rows))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = Observation()
            if warmup_discard and cell.count == 0 and cell.warmups_seen == 0:
                cell.warmups_seen += 1
                return
            cell.count += 1
            if cell.count == 1:
                cell.wall_s = float(wall_s)
            else:
                cell.wall_s += self.alpha * (float(wall_s) - cell.wall_s)

    def observed(self, op: str, path: str, rows: int) -> Optional[Observation]:
        """Snapshot (copy) of a cell — safe to read while concurrent
        executors record into the live cell."""
        with self._lock:
            cell = self._cells.get((op, path, size_bucket(rows)))
            return None if cell is None else dataclasses.replace(cell)

    def blend(self, predicted: float, op: str, path: str, rows: int) -> float:
        cell = self.observed(op, path, rows)
        if cell is None or cell.count == 0:
            return float(predicted)
        w = cell.count / (cell.count + self.confidence)
        return (1.0 - w) * float(predicted) + w * cell.wall_s

    def clear(self) -> None:
        with self._lock:
            self._cells.clear()

    def snapshot(self) -> Dict[Tuple[str, str, int], Observation]:
        """Copy of the cells (diagnostics / benchmark reporting)."""
        with self._lock:
            return {k: dataclasses.replace(v) for k, v in self._cells.items()}

    def __len__(self) -> int:
        return len(self._cells)


# Opt-in process-wide profile.  PathSelector defaults to a *fresh* profile
# per selector (deterministic tests, no cross-query-stream pollution); pass
# this explicitly to share observations across executors in one process.
DEFAULT_PROFILE = RuntimeProfile()
