"""Flash attention over torch tensors, in the model layout.

The contract is that of ``src/repro/kernels/flash_attention/ops.py``
(``flash_attention``) and of the reference's ``chunked_attention``: q
``[B, Sq, H, D]``, k/v ``[B, Sk, KH, D(v)]`` → ``[B, Sq, H, Dv]`` in q's
dtype, with ``q_offset`` placing query row i at position ``q_offset + i``.
A CUDA tensor launches a hand-written kernel of :mod:`.kernel` (bf16 on
``wgmma``, float32 in the 3xTF32 split on ``mma.sync``) or raises, a CPU
tensor takes the plain version of :mod:`.ref`.  The kernels read their
inputs through their strides, so a view (a slice of a fused projection, a
transpose of ``[B, H, S, D]``) goes in without a copy; the last dimension
must be contiguous, and bf16 strides whole 16 bytes.  The tile sizes are
the kernel's own on the card; on the CPU ``q_blk``/``kv_blk`` are the plain
version's tiles.

Gradients.  On the CPU autograd runs through the plain version.  On the
card, a call that needs a gradient (grad mode on and q, k or v requiring
one) goes through :class:`FlashAttention`, an ``autograd.Function`` whose
forward is the kernel of q's dtype writing each row's logsumexp and whose
backward is the backward kernel of that dtype, no atomics, the same bits
every run: float32 runs ``csrc/flash_attention.cu``'s logsumexp entry and
``csrc/flash_attention_bwd.cu`` (the 3xTF32 split on the tensor cores),
bfloat16 the logsumexp instantiation of ``csrc/flash_attention_sm90.cu``
and ``csrc/flash_attention_bwd_bf16.cu`` (bf16 ``wgmma`` with float32
accumulators, fed by TMA; the gradients in bf16).  A call that needs none
(serving, under ``torch.no_grad()``) launches the forward kernel alone, as
before.

On a mesh.  DTensor inputs never reach a kernel's extension call: they
run through ``local_map`` (:func:`_sharded`), each rank's call the ordinary
one on its shards (the kernel on a CUDA shard, the plain version on a CPU
shard), with the layout the reference constrains: the batch over the
data-parallel axes and the query heads over ``"model"`` (where they
divide), K/V split over the batch only.  Each rank reads the K/V heads its
query heads use, so the GQA mapping is the global one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...distributed.sharding import (axis_placements, dp_split, is_dtensor,
                                     mesh_axis_sizes)

from . import kernel as _k
from . import ref as _ref

__all__ = ["flash_attention", "FlashAttention"]


class FlashAttention(torch.autograd.Function):
    """The card's differentiable attention: the forward kernel of q's
    dtype with its row logsumexp, and the backward kernel of that dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, q_offset):
        out, lse = _k.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window, cap=cap,
                                          scale=scale, q_offset=q_offset,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, cap=cap, scale=scale,
                        q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                    and not _k.aligned16(dout)):
            dout = dout.contiguous()
        dq, dk, dv = _k.flash_attention_bwd(q, k, v, out, lse, dout,
                                            **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _local_kv(q, k, v, H: int, r: int):
    """The K/V heads the local query heads ``[r·H_l, (r+1)·H_l)`` of a
    global ``H`` use, as a slice where the GQA group and the local heads
    nest, else gathered one a query head (a group of 1)."""
    H_l, KH = q.shape[2], k.shape[2]
    G = H // KH
    if H_l == H:
        return k, v
    if H_l % G == 0 or G % H_l == 0:
        lo, hi = r * H_l // G, ((r + 1) * H_l - 1) // G + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = (r * H_l + torch.arange(H_l, device=k.device)) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _sharded(q, k, v, opts):
    """Attention over DTensors through ``local_map``."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    sizes = mesh_axis_sizes(mesh)
    B, _, H, _ = q.shape
    batch = {a: 0 for a in dp_split(mesh, B)}
    heads = "model" in sizes and H % sizes["model"] == 0
    q_pl = axis_placements(mesh, {**batch, **({"model": 2} if heads else {})})
    kv_pl = axis_placements(mesh, batch)
    # each model rank's dK/dV covers its own query heads: a partial sum
    kv_grad = axis_placements(mesh, batch, ("model",) if heads else ())
    r = mesh.get_local_rank("model") if heads else 0

    def local(ql, kl, vl):
        kl, vl = _local_kv(ql, kl, vl, H, r)
        return flash_attention(ql, kl, vl, **opts)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    q_blk: int = 256, kv_blk: int = 64) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if is_dtensor(q):
        return _sharded(q, k, v, dict(causal=causal, window=window, cap=cap,
                                      scale=scale, q_offset=q_offset,
                                      q_blk=q_blk, kv_blk=kv_blk))
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, cap, scale,
                                        q_offset)
        return _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      cap=cap, scale=scale, q_offset=q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    cap=cap, scale=scale, q_offset=q_offset,
                                    q_blk=q_blk, kv_blk=kv_blk)
