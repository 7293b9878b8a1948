"""Attention: chunked (online-softmax) attention, GQA, MLA, local/global.

The counterpart of ``src/repro/models/attention.py``.
:func:`chunked_attention` keeps the reference's contract and has one route
per device: on the card it launches the hand-written flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), on the CPU it runs that
kernel's plain version with ``q_chunk``/``kv_chunk`` as its tiles.
:func:`decode_attention` is plain PyTorch, as no TPU kernel replaced it.

MLA (DeepSeek-V2's multi-head latent attention) keeps the compressed
``[B, S, kv_lora_rank + qk_rope_dim]`` cache.  Its prefill expands K and V
per head and goes through the same flash kernel (q and k 192 wide, v 128
at DeepSeek-V2-Lite's widths, scale ``1/sqrt(qk_nope + qk_rope)``); its
decode is the reference's *absorbed* form, plain einsums that contract the
query against the compressed cache.

Decode writes the new token's K/V (or compressed entry) into the caller's
cache tensors in place (the reference returns updated copies through
``dynamic_update_slice``), which saves a copy of the cache per step.  Like
``dynamic_update_slice``, a write at a position past the cache's end lands
on its last position, and the step then attends to every position.

Under a mesh (DTensor inputs in a ``with mesh:`` scope) the reference's
sharding constraints (:mod:`.pspec`) hold at the reference's places;
outside one they return their input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..distributed.sharding import is_dtensor
from ..kernels.flash_attention.ops import flash_attention
from .common import apply_rope, init_dense, init_rmsnorm, rmsnorm, softcap
from .pspec import axis_size, constrain, constrain_kv_cache

__all__ = [
    "chunked_attention", "decode_attention",
    "init_gqa", "gqa_forward", "gqa_decode",
    "init_mla", "mla_forward", "mla_decode",
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
    q = constrain(q, "dp", None, "model", None)
    k = constrain(k, "dp", None, None, None)
    v = constrain(v, "dp", None, None, None)
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
    if is_dtensor(q) and KH % axis_size("model"):
        # the grouped view splits the heads: gather them first on a mesh
        # whose "model" axis does not divide the KV heads
        q = constrain(q, "dp", None, None, None)
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    # the batch pinned: the scores over a long cache stay batch-sharded
    s = constrain(s, "dp", None, None, None)
    s = softcap(s, cap)
    pos_k = torch.arange(S, device=q.device)
    mask = pos_k <= cur_pos
    if window is not None:
        mask &= (cur_pos - pos_k) < window
    s = torch.where(mask, s, _NEG_INF)
    p = constrain(torch.softmax(s, dim=-1), "dp", None, None, None)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def _write_at(cache: torch.Tensor, entry: torch.Tensor, cur_pos: int) -> None:
    """Write ``entry`` ``[B, 1, ...]`` into ``cache`` ``[B, S, ...]`` at
    ``cur_pos`` clamped into ``[0, S - 1]``, in place."""
    at = min(max(cur_pos, 0), cache.shape[1] - 1)
    cache[:, at:at + 1] = entry.to(cache.dtype)


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


def _split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """``[B, S, n·dh]`` → ``[B, S, n, dh]``.  On a mesh whose ``"model"``
    axis does not divide ``n`` the last dimension is gathered first: a
    DTensor cannot split a dimension sharded across head boundaries."""
    if is_dtensor(t) and n % axis_size("model"):
        t = constrain(t, "dp", None, None)
    return t.reshape(t.shape[0], t.shape[1], n, dh)


def _gqa_qkv(params, x, cfg, sin, cos):
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(_split_heads(q, H, Dh), sin, cos)
    k = apply_rope(_split_heads(k, KH, Dh), sin, cos)
    return q, k, _split_heads(v, KH, Dh)


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
    q, k, v = _gqa_qkv(params, x, cfg, sin, cos)
    _write_at(k_cache, k, cur_pos)
    _write_at(v_cache, v, cur_pos)
    # the cache keeps its layout through the write (no re-layout a step)
    k_cache = constrain_kv_cache(k_cache)
    v_cache = constrain_kv_cache(v_cache)
    out = decode_attention(q, k_cache, v_cache, cur_pos, window=window,
                           cap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.num_heads
    rank, nope, rp, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                          cfg.v_head_dim)
    return {"wq": init_dense(gen, d, H * (nope + rp), dtype, device),
            "w_dkv": init_dense(gen, d, rank + rp, dtype, device),
            "kv_norm": init_rmsnorm(rank, dtype, device),
            "w_uk": init_dense(gen, rank, H * nope, dtype, device),
            "w_uv": init_dense(gen, rank, H * vd, dtype, device),
            "wo": init_dense(gen, H * vd, d, dtype, device)}


def _mla_q(params, x, cfg, sin, cos):
    B, S, _ = x.shape
    H, nope, rp = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ params["wq"]).reshape(B, S, H, nope + rp)
    return q[..., :nope], apply_rope(q[..., nope:], sin, cos)


def _mla_ckv(params, x, cfg, sin, cos):
    """x ``[B, S, d]`` → the compressed latent ``c`` ``[B, S, rank]``
    (normed) and the shared single-head rope key ``[B, S, rope]``."""
    rank = cfg.kv_lora_rank
    ckv = x @ params["w_dkv"]
    c = rmsnorm(params["kv_norm"], ckv[..., :rank], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, rank:], sin, cos)[:, :, 0, :]
    return c, k_rope


def mla_forward(params, x, cfg, sin, cos, *, q_chunk=256, kv_chunk=1024):
    """Prefill MLA: K and V expanded per head, flash attention.  Returns
    ``(out [B, S, d], cache entry [B, S, rank + rope])``.  K is the
    per-head ``k_nope`` beside the shared rope key, materialised as the
    reference's ``concatenate`` does: a stride-0 head view would break the
    bf16 kernel's 16-byte stride rule."""
    B, S, _ = x.shape
    H, nope, rp, vd = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    q_nope, q_rope = _mla_q(params, x, cfg, sin, cos)
    c, k_rope = _mla_ckv(params, x, cfg, sin, cos)
    k_nope = (c @ params["w_uk"]).reshape(B, S, H, nope)
    v = (c @ params["w_uv"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rp)],
                  dim=-1)
    out = chunked_attention(q, k, v, causal=True,
                            scale=1.0 / math.sqrt(nope + rp),
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    cache = torch.cat([c, k_rope], dim=-1)
    return out.reshape(B, S, H * vd) @ params["wo"], cache


def mla_decode(params, x, cfg, sin, cos, ckv_cache, cur_pos: int):
    """Absorbed-MLA decode of x ``[B, 1, d]`` against the compressed cache
    ``[B, S, rank + rope]``, which takes the new entry in place at
    ``cur_pos`` (clamped).  ``W_uk`` is folded into the query and ``W_uv``
    applied after the softmax, so the scores contract against the cache as
    it is, in float32.  Returns ``(out [B, 1, d], ckv_cache)``."""
    B = x.shape[0]
    H, nope, rp, vd = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
    rank = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(params, x, cfg, sin, cos)
    c_new, k_rope_new = _mla_ckv(params, x, cfg, sin, cos)
    _write_at(ckv_cache, torch.cat([c_new, k_rope_new], dim=-1), cur_pos)
    ckv_cache = constrain_kv_cache(ckv_cache)
    cache_c = ckv_cache[..., :rank].float()
    cache_rope = ckv_cache[..., rank:].float()
    w_uk = params["w_uk"].reshape(rank, H, nope).float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk)
    s = torch.einsum("bhr,bsr->bhs", q_abs, cache_c)
    s = s + torch.einsum("bhp,bsp->bhs", q_rope[:, 0].float(), cache_rope)
    s = constrain(s, "dp", "model", None) * (1.0 / math.sqrt(nope + rp))
    mask = torch.arange(ckv_cache.shape[1], device=x.device) <= cur_pos
    p = torch.softmax(torch.where(mask, s, _NEG_INF), dim=-1)
    o_c = torch.einsum("bhs,bsr->bhr", p, cache_c)
    w_uv = params["w_uv"].reshape(rank, H, vd).float()
    out = torch.einsum("bhr,rhv->bhv", o_c, w_uv)
    out = out.reshape(B, 1, H * vd).to(x.dtype) @ params["wo"]
    return out, ckv_cache
