"""Training driver: the data pipeline (relational preprocessing through
the port's engine), the trainer, checkpoints with resume.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 20 --ckpt-dir build/ckpt [--device cpu]

The counterpart of ``src/repro/launch/train.py``, with its flags plus
``--device`` (the CUDA card by default; ``cpu`` runs the plain versions of
the kernels), ``--layers`` (cut the model to its first N layers) and
``--dtype`` (float32 by default, as the reference trains; ``bfloat16``
trains bf16 parameters with float32 optimizer state, on the card through
the bf16 attention forward with its logsumexp and the bf16 backward
kernel).  Weights are random, drawn from a ``torch.Generator`` seeded
with 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataPipeline, PipelineConfig
from ..device import resolve_device
from ..models import init_model
from ..train.checkpoint import Checkpointer, latest_step, restore_checkpoint
from ..train.optimizer import make_optimizer
from ..train.trainer import TrainPolicy, make_train_step
from ..train.tree import tree_leaves

__all__ = ["main"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--moe-dispatch", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="run the first N layers of the config")
    ap.add_argument("--dtype", choices=tuple(_DTYPES), default="float32")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    print(f"arch={cfg.name} layers={cfg.num_layers} "
          f"params={cfg.param_count() / 1e6:.1f}M "
          f"(active {cfg.active_param_count() / 1e6:.1f}M) on {dev}")

    policy = TrainPolicy(moe_dispatch=args.moe_dispatch, remat=False)
    opt = make_optimizer("adamw", lr=args.lr)
    step_fn = make_train_step(cfg, opt, policy)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(gen, cfg, dtype=_DTYPES[args.dtype], device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt_state = opt.init(params)
    start = 0
    ckpt = (Checkpointer(args.ckpt_dir, args.ckpt_interval)
            if args.ckpt_dir else None)
    if ckpt and latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        print(f"resumed from step {start}")

    pipe = DataPipeline(PipelineConfig(
        num_docs=4000, vocab=cfg.vocab_size, seq_len=args.seq_len,
        batch_size=args.batch, device=str(dev)))
    pipe.restore({"consumed": start, "seed": 0})
    it = iter(pipe)

    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses[step] = float(metrics["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[step]:.4f} "
                  f"|g| {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
        if ckpt:
            ckpt.maybe_save(step + 1, (params, opt_state))
    tokens = (args.steps - start) * args.batch * args.seq_len
    dt = time.time() - t0
    print(f"done: {tokens} tokens in {dt:.1f}s "
          f"({tokens / max(dt, 1e-9):.0f} tok/s)")
    return {"losses": losses, "start": start, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
