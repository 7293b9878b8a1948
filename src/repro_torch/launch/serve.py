"""Serving entry point: continuous batching over the decode step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --requests 8 --max-new 16 [--device cpu]

The counterpart of ``src/repro/launch/serve.py``, with the same flags plus
``--device`` (CUDA by default).  Weights are random, drawn from a
``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import init_model
from ..serving.engine import BatchScheduler, Request, generate

__all__ = ["make_requests", "serve", "main"]


def make_requests(cfg: ArchConfig, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` requests with random prompts and priorities 0..2."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, prompt_len),
                    max_new_tokens=max_new,
                    priority=int(rng.integers(0, 3)))
            for i in range(n)]


def serve(params, cfg: ArchConfig, requests: List[Request], batch_size: int,
          *, device=None, step_seconds: Optional[list] = None,
          log=print) -> dict:
    """Admit the requests through a :class:`BatchScheduler` and generate
    each admitted batch; fills every request's ``output``."""
    sched = BatchScheduler(batch_size, device=device)
    for r in requests:
        sched.submit(r)
    t0 = time.perf_counter()
    served, tokens, batches = 0, 0, []
    while sched.queue:
        batch_reqs = sched.admit(batch_size)
        prompts = np.stack([r.prompt for r in batch_reqs])
        max_new = max(r.max_new_tokens for r in batch_reqs)
        outs = generate(params, cfg, prompts, max_new,
                        step_seconds=step_seconds)
        for r, o in zip(batch_reqs, outs):
            r.output = [int(x) for x in o[:r.max_new_tokens]]
            served += 1
            tokens += len(r.output)
        batches.append([r.rid for r in batch_reqs])
        if log is not None:
            log(f"batch of {len(batch_reqs)} done "
                f"(priorities {[r.priority for r in batch_reqs]})")
    return {"served": served, "tokens": tokens, "batches": batches,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only architecture: no decode/serving path")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(gen, cfg, device=dev)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new)
    rep = serve(params, cfg, reqs, args.batch_size, device=dev)
    dt = rep["seconds"]
    print(f"served {rep['served']} requests / {rep['tokens']} tokens in "
          f"{dt:.1f}s ({rep['tokens'] / max(dt, 1e-9):.1f} tok/s) on {dev}")
    return rep


if __name__ == "__main__":
    main()
