"""Fault tolerance: retries, checkpoint/resume, straggler surfacing, and
elastic mesh re-planning.  The counterpart of
``src/repro/train/fault_tolerance.py``; host logic, the same over the
port's trees of tensors.

  * ``ResilientLoop`` — drives train steps; on a step failure it restores
    the last checkpoint and replays the data pipeline deterministically;
    bounded retries; a per-step wall-time watchdog that *records*
    stragglers (the signal for re-sharding around a slow host at the next
    restart).
  * ``plan_mesh`` — elastic re-planning: the largest (data × model) grid
    that the surviving device count supports, shrinking the data axis
    (model-parallel groups must stay whole: parameter shards live there).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

from .checkpoint import Checkpointer

__all__ = ["plan_mesh", "ResilientLoop", "StepFailure"]


class StepFailure(RuntimeError):
    pass


def plan_mesh(num_devices: int, model_parallel: int = 16,
              pod_size: int = 256) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Elastic mesh plan for the devices that are actually alive: the
    model axis stays whole, the data (and pod) axes take the largest
    multiple of ``model_parallel`` devices.  512 → (2, 16, 16) over
    (pod, data, model); 248 → (15, 16) over (data, model)."""
    if num_devices < model_parallel:
        raise ValueError(
            f"cannot keep model axis: {num_devices} < {model_parallel}")
    usable = (num_devices // model_parallel) * model_parallel
    data = usable // model_parallel
    if usable >= 2 * pod_size and usable % pod_size == 0:
        pods = usable // pod_size
        return (pods, pod_size // model_parallel, model_parallel), (
            "pod", "data", "model")
    return (data, model_parallel), ("data", "model")


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    retries: int
    restores: int
    straggler_steps: List[int]
    losses: List[float]


class ResilientLoop:
    """Checkpoint/restart training driver."""

    def __init__(self, step_fn: Callable, ckpt: Checkpointer,
                 data_state_fn: Callable[[], dict],
                 data_restore_fn: Callable[[dict], None],
                 max_retries: int = 3,
                 straggler_factor: float = 3.0):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.data_state_fn = data_state_fn
        self.data_restore_fn = data_restore_fn
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor

    def run(self, state: Any, data_iter_factory: Callable, num_steps: int,
            start_step: int = 0, fail_hook: Optional[Callable] = None
            ) -> Tuple[Any, LoopReport]:
        retries = restores = 0
        stragglers: List[int] = []
        losses: List[float] = []
        ema_wall = None
        step = start_step
        it = iter(data_iter_factory())
        while step < num_steps:
            batch = next(it)
            t0 = time.perf_counter()
            try:
                if fail_hook:
                    fail_hook(step)  # test fault injection
                state, loss = self.step_fn(state, batch)
            except Exception:
                retries += 1
                if retries > self.max_retries:
                    raise
                # restore: last durable checkpoint + deterministic data replay
                state, ck_step = self.ckpt.restore_or_init(
                    template=state, init_fn=lambda: state)
                if isinstance(ck_step, int) and ck_step:
                    step = ck_step
                restores += 1
                self.data_restore_fn({"consumed": step, "seed": 0})
                it = iter(data_iter_factory())
                continue
            wall = time.perf_counter() - t0
            ema_wall = wall if ema_wall is None else 0.9 * ema_wall + 0.1 * wall
            if ema_wall and wall > self.straggler_factor * ema_wall:
                stragglers.append(step)  # mitigation signal (see module doc)
            losses.append(float(loss))
            step += 1
            self.ckpt.maybe_save(step, state)
        return state, LoopReport(step - start_step, retries, restores,
                                 stragglers, losses)
