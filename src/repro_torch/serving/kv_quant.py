"""Int8 KV-cache quantization: half the bytes of a bf16 decode cache.

The counterpart of ``src/repro/serving/kv_quant.py``.  Each (position,
head) row of ``D`` values gets its own symmetric scale, ``max |x| / 127``,
so a token with outlier keys cannot coarsen the codes of any other
position.  Entries are quantized as they are appended and the cache is
dequantized whole at attention time, through the port's own
:func:`repro_torch.models.attention.decode_attention`.

The reference returns an updated copy from :func:`append_quantized`
(``dynamic_update_slice``); the port writes the new entry into the cache's
tensors in place, as its decode step does with K/V, and returns the same
tensors.  A position past the cache's end lands on its last position, as
``dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.attention import decode_attention

__all__ = ["QuantizedKV", "quantize_kv", "dequantize_kv", "append_quantized",
           "decode_attention_quantized"]


class QuantizedKV(NamedTuple):
    q: torch.Tensor       # int8 [B, S, KH, D]
    scale: torch.Tensor   # float32 [B, S, KH], one a (position, head)


def quantize_kv(x: torch.Tensor) -> QuantizedKV:
    """x ``[B, S, KH, D]`` → int8 codes and a per-(position, head)
    scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return QuantizedKV(q.to(torch.int8), scale)


def dequantize_kv(qkv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (qkv.q.float() * qkv.scale[..., None]).to(dtype)


def append_quantized(cache: QuantizedKV, new: torch.Tensor,
                     pos: int) -> QuantizedKV:
    """Quantize one new ``[B, 1, KH, D]`` entry and write it into the
    cache at ``pos`` (clamped into ``[0, S - 1]``), in place."""
    entry = quantize_kv(new)
    at = min(max(int(pos), 0), cache.q.shape[1] - 1)
    cache.q[:, at:at + 1] = entry.q
    cache.scale[:, at:at + 1] = entry.scale
    return cache


def decode_attention_quantized(q: torch.Tensor, k_cache: QuantizedKV,
                               v_cache: QuantizedKV, cur_pos: int, **kw):
    """:func:`~repro_torch.models.attention.decode_attention` against int8
    caches, dequantized to q's dtype at use."""
    return decode_attention(q, dequantize_kv(k_cache, q.dtype),
                            dequantize_kv(v_cache, q.dtype), cur_pos, **kw)
