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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import kernel as _k
from . import ref as _ref

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    q_blk: int = 256, kv_blk: int = 64) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      cap=cap, scale=scale, q_offset=q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    cap=cap, scale=scale, q_offset=q_offset,
                                    q_blk=q_blk, kv_blk=kv_blk)
