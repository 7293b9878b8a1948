"""Serving: prefill/decode step factories + a continuous-batching scheduler.

The counterpart of ``src/repro/serving/engine.py``.  The scheduler orders
admitted requests with the relational core's tensor sort (multi-key:
priority, arrival), which launches the radix sort kernel on the card, and
:func:`generate` drives the decode step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import Relation, tensor_sort
from ..device import resolve_device, synchronize, to_host
from ..models import decode_step, init_cache, prefill

__all__ = ["make_prefill_step", "make_decode_step", "Request",
           "BatchScheduler", "generate"]


def make_prefill_step(cfg: ArchConfig, **fw_kw) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, **fw_kw)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def step(params, cache, batch):
        return decode_step(params, cfg, cache, batch)
    return step


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] token ids
    max_new_tokens: int
    priority: int = 0
    arrived_s: float = dataclasses.field(default_factory=time.monotonic)
    output: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


class BatchScheduler:
    """Admits up to ``batch_size`` requests; orders the admission queue via
    the tensor execution path (multi-key sort: priority desc, arrival asc)
    on ``device`` (CUDA by default)."""

    def __init__(self, batch_size: int, device=None):
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.queue: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self, free_slots: int) -> List[Request]:
        if not self.queue or free_slots <= 0:
            return []
        rel = Relation({
            "neg_priority": np.asarray([-r.priority for r in self.queue],
                                       np.int64),
            "arrival_us": np.asarray([int(r.arrived_s * 1e6)
                                      for r in self.queue], np.int64),
            "idx": np.arange(len(self.queue), dtype=np.int64),
        })
        ordered, _ = tensor_sort(rel, ["neg_priority", "arrival_us"],
                                 device=self.device)
        take = [self.queue[i] for i in ordered["idx"][:free_slots]]
        taken_ids = {r.rid for r in take}
        self.queue = [r for r in self.queue if r.rid not in taken_ids]
        return take


def generate(params, cfg: ArchConfig, prompts: np.ndarray,
             max_new_tokens: int, *, greedy: bool = True,
             cache_len: Optional[int] = None,
             step_seconds: Optional[list] = None) -> np.ndarray:
    """Batched greedy generation on the params' device: the prompt goes
    token by token through the decode step, then each step feeds back its
    argmax.  Returns ``[B, max_new_tokens]`` token ids.  With
    ``step_seconds`` (a list), each step ends in a synchronise and its wall
    time is appended."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented, as "
                                  "in the reference")
    table = params["embed"]["table"]
    dev = table.device
    B, S = prompts.shape
    total = S + max_new_tokens
    cache = init_cache(cfg, B, cache_len or total, device=dev)
    step = make_decode_step(cfg)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                             device=dev)
    out = []
    last = None
    for t in range(total - 1):
        if t < S:
            tok = tokens[:, t:t + 1]
        else:
            tok = last
            out.append(tok[:, 0])
        t0 = time.perf_counter()
        logits, cache = step(params, cache, {"tokens": tok})
        last = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        if step_seconds is not None:
            synchronize(dev)
            step_seconds.append(time.perf_counter() - t0)
    out.append(last[:, 0])
    (host,) = to_host([torch.stack(out, dim=1)])
    return np.array(host)
