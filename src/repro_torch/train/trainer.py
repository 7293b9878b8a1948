"""Train-step factory: loss, gradient accumulation, recomputation, the
optimizer's update.  The counterpart of ``src/repro/train/trainer.py``.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  The loss is ``hidden_forward`` plus
``chunked_softmax_xent`` (the ``[B, S, V]`` logits never exist) and the
MoE aux loss; the gradients come from ``.backward()``, through the flash
attention and MoE dispatch/combine kernels' backward on the card.
Microbatch m is the strided rows ``{r · n_mb + m}`` of the batch, as in
the reference, with the gradients summed in ``grad_accum_dtype``.  The
parameters must be leaf tensors with ``requires_grad=True``; the step
leaves each one's ``.grad`` set (None where the loss never reached it,
which the optimizer then reads as zeros, as ``jax.grad`` gives them) and
updates the parameters and the optimizer state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import is_dtensor
from ..models import cross_entropy_loss, forward
from ..models.transformer import chunked_softmax_xent, hidden_forward
from .optimizer import Optimizer
from .tree import tree_leaves, tree_unflatten

__all__ = ["TrainPolicy", "make_train_step", "make_eval_step",
           "default_policy"]


@dataclasses.dataclass(frozen=True)
class TrainPolicy:
    optimizer: str = "adamw"
    microbatches: int = 1
    remat: bool = True
    moe_dispatch: str = "auto"
    moe_budget_bytes: int = 2 << 30
    moe_token_chunk: int = 32_768
    remat_policy: str = "full"   # full (recompute all) | dots (save matmul outs)
    grad_accum_dtype: Any = torch.float32
    #: a ``distributed.sharding.NamedSharding``: keep DTensor [B,S,V]
    #: logits vocab-sharded
    logits_sharding: Any = None


def default_policy(cfg: ArchConfig) -> TrainPolicy:
    """Adafactor with bf16 gradient sums for the >100 B hybrid, so its
    optimizer state stays small; AdamW elsewhere (the reference's)."""
    if cfg.param_count() > 100e9:
        return TrainPolicy(optimizer="adafactor", microbatches=1,
                           grad_accum_dtype=torch.bfloat16)
    return TrainPolicy(optimizer="adamw", microbatches=1)


def _loss_for_batch(params, cfg: ArchConfig, mb, policy: TrainPolicy):
    hidden, aux = hidden_forward(
        params, cfg, mb, remat=policy.remat, remat_policy=policy.remat_policy,
        moe_dispatch=policy.moe_dispatch, moe_budget=policy.moe_budget_bytes,
        moe_token_chunk=policy.moe_token_chunk)
    return chunked_softmax_xent(params, cfg, hidden, mb["labels"],
                                logits_sharding=policy.logits_sharding) + aux


def _microbatch(batch, m: int, n_mb: int):
    """Rows ``{r · n_mb + m}`` of every input; ``positions`` is ``[3, B,
    S]``, its rows on the second axis.  Taken as the reference takes them,
    the row axis split into ``(B / n_mb, n_mb)`` and index ``m`` of the
    second factor (the same view as ``v[m::n_mb]``), which keeps a
    DTensor's row shards on their ranks."""
    def rows(v, axis):
        B = v.shape[axis]
        split = v.reshape(v.shape[:axis] + (B // n_mb, n_mb)
                          + v.shape[axis + 1:])
        return split.select(axis + 1, m)
    return {k: rows(v, 1 if k == "positions" else 0)
            for k, v in batch.items()}


def _param_layout(p, g):
    """A DTensor gradient in its parameter's layout (autograd can hand it
    back as a partial sum or split otherwise); anything else as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    policy: Optional[TrainPolicy] = None) -> Callable:
    policy = policy or default_policy(cfg)
    n_mb = policy.microbatches

    def loss_and_grads(params, mb):
        """The loss of ``mb`` (detached) and each leaf's gradient, left in
        its ``.grad`` too (None where the loss did not reach it)."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss = _loss_for_batch(params, cfg, mb, policy)
        loss.backward()
        for p in leaves:
            p.grad = _param_layout(p, p.grad)
        return loss.detach(), [p.grad for p in leaves]

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if n_mb == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            acc = [torch.zeros_like(p, dtype=policy.grad_accum_dtype,
                                    requires_grad=False) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for m in range(n_mb):
                mb_loss, mb_grads = loss_and_grads(
                    params, _microbatch(batch, m, n_mb))
                for a, g in zip(acc, mb_grads):
                    if g is not None:
                        a.add_(g.to(a.dtype))
                loss = loss + mb_loss
            loss = loss / n_mb
            grads = [a / n_mb for a in acc]
            for p, g in zip(leaves, grads):
                p.grad = g.to(p.dtype)
        grad_tree = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        params, opt_state, opt_metrics = optimizer.update(grad_tree,
                                                          opt_state, params)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def make_eval_step(cfg: ArchConfig,
                   policy: Optional[TrainPolicy] = None) -> Callable:
    policy = policy or default_policy(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, aux, _ = forward(params, cfg, batch,
                                 moe_dispatch=policy.moe_dispatch)
        return cross_entropy_loss(logits, batch["labels"]) + aux

    return eval_step
