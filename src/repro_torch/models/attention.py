"""Attention: chunked (online-softmax) attention, GQA, local/global.

The counterpart of ``src/repro/models/attention.py:35-224``.
:func:`chunked_attention` keeps the reference's contract and has one route
per device: on the card it launches the hand-written flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), on the CPU it runs that
kernel's plain version with ``q_chunk``/``kv_chunk`` as its tiles.
:func:`decode_attention` is plain PyTorch, as no TPU kernel replaced it.

MLA (``attention.py:231-314`` of the reference) is not ported yet
(ROADMAP Queue 1 item 11): :func:`init_mla` raises.

Decode writes the new token's K/V into the caller's cache tensors in place
(the reference returns updated copies through ``dynamic_update_slice``),
which saves a copy of the cache per step.  Like ``dynamic_update_slice``, a
write at a position past the cache's end lands on its last position, and the
step then attends to every position.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import apply_rope, init_dense, softcap

__all__ = [
    "chunked_attention", "decode_attention",
    "init_gqa", "gqa_forward", "gqa_decode", "init_mla",
]

_NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      window: Optional[int] = None,
                      cap: Optional[float] = None,
                      scale: Optional[float] = None, q_chunk: int = 256,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """q ``[B, Sq, H, D]``; k ``[B, Sk, KH, D]``; v ``[B, Sk, KH, Dv]`` →
    ``[B, Sq, H, Dv]`` in q's dtype."""
    return flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                           scale=scale, q_offset=q_offset, q_blk=q_chunk,
                           kv_blk=kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos: int, *,
                     window: Optional[int] = None,
                     cap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, 1, H, D]`` against caches ``[B, S, KH, D(v)]`` holding
    positions ``0..cur_pos``."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    s = softcap(s, cap)
    pos_k = torch.arange(S, device=q.device)
    mask = pos_k <= cur_pos
    if window is not None:
        mask &= (cur_pos - pos_k) < window
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg, dtype=torch.float32, device=None):
    d, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": init_dense(gen, d, H * Dh, dtype, device),
         "wk": init_dense(gen, d, KH * Dh, dtype, device),
         "wv": init_dense(gen, d, KH * Dh, dtype, device),
         "wo": init_dense(gen, H * Dh, d, dtype, device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KH * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KH * Dh,), dtype=dtype, device=device)
    return p


def init_mla(gen, cfg, dtype=torch.float32, device=None):
    raise NotImplementedError(
        "MLA (multi-head latent attention) is not ported yet: ROADMAP "
        "Queue 1 item 11")


def _gqa_qkv(params, x, cfg, sin, cos):
    B, S, _ = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q.reshape(B, S, H, Dh), sin, cos)
    k = apply_rope(k.reshape(B, S, KH, Dh), sin, cos)
    return q, k, v.reshape(B, S, KH, Dh)


def gqa_forward(params, x, cfg, sin, cos, *, window=None, is_causal=True,
                q_chunk=256, kv_chunk=1024):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(params, x, cfg, sin, cos)
    out = chunked_attention(q, k, v, causal=is_causal, window=window,
                            cap=cfg.attn_logit_softcap, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return out, (k, v)


def gqa_decode(params, x, cfg, sin, cos, k_cache, v_cache, cur_pos: int, *,
               window=None):
    """x ``[B, 1, d]``; caches ``[B, S, KH, D]`` holding the history.
    Writes the new K/V in place at ``cur_pos`` clamped into ``[0, S - 1]``
    (as the reference's ``dynamic_update_slice`` does), attends with the
    mask of ``cur_pos`` itself, and returns ``(out, (k_cache, v_cache))``."""
    B = x.shape[0]
    at = min(max(cur_pos, 0), k_cache.shape[1] - 1)
    q, k, v = _gqa_qkv(params, x, cfg, sin, cos)
    k_cache[:, at:at + 1] = k.to(k_cache.dtype)
    v_cache[:, at:at + 1] = v.to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, cur_pos, window=window,
                           cap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return out, (k_cache, v_cache)
