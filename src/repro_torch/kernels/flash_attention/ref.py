"""Plain PyTorch versions of the flash-attention kernel.

:func:`flash_attention_ref` repeats the arithmetic of the CUDA kernels in
``csrc/flash_attention_sm90.cu`` (bf16) and ``csrc/flash_attention.cu``
(float32) and of the reference's ``chunked_attention``:
an online softmax over KV tiles (query tiles only bound the memory), in
float32, with the scale before the tanh soft-cap, masked scores at -1e30,
P rounded to V's dtype before the PV product and l summed from the
unrounded P, and the output ``acc / max(l, 1e-30)`` cast to q's dtype.  GQA
reads kv head ``h // G`` through a reshape of the query heads, with no
repeat of K/V.  The wrappers in :mod:`.ops` take it for CPU tensors; the
tests and ``chip_smoke.py`` hold the kernel against it on the card.

:func:`flash_attention_bwd_ref` is the plain version of the backward
kernel (``csrc/flash_attention_bwd.cu``): from the forward's output and
row logsumexp (``flash_attention_ref(..., return_lse=True)``; +inf for a
row with no visible key, whose output is the mean of V over every key) it
recomputes P one query tile at a time against all keys and returns
``(dq, dk, dv)`` in float32.

:func:`attention_ref` is the dense-softmax oracle of
``src/repro/kernels/flash_attention/ref.py`` (layout ``[B, H, S, D]``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "attention_ref",
           "NEG_INF"]

NEG_INF = -1e30


def _mask(pos_q, pos_k, causal, window):
    mask = torch.ones((pos_q.numel(), pos_k.numel()), dtype=torch.bool,
                      device=pos_q.device)
    if causal:
        mask &= pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        mask &= (pos_q[:, None] - pos_k[None, :]) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        q_blk: int = 256, kv_blk: int = 64,
                        return_lse: bool = False):
    """q ``[B, Sq, H, D]``; k/v ``[B, Sk, KH, D(v)]`` → ``[B, Sq, H, Dv]``
    in q's dtype; with ``return_lse`` → ``(out, lse)``, lse ``[B, H, Sq]``
    float32: each row's ``m + log(l)``, +inf where no key is visible."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    q_blk, kv_blk = max(1, min(q_blk, Sq)), max(1, min(kv_blk, Sk))
    for q0 in range(0, Sq, q_blk):
        qb = q[:, q0:q0 + q_blk].float()
        n = qb.shape[1]
        qg = qb.reshape(B, n, KH, G, D)
        pos_q = q_offset + q0 + torch.arange(n, device=dev)
        m = torch.full((B, KH, G, n), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KH, G, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KH, G, n, Dv), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Sk, kv_blk):
            kb = k[:, k0:k0 + kv_blk]
            vb = v[:, k0:k0 + kv_blk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float()) * scale
            if cap is not None:
                s = torch.tanh(s / cap) * cap
            pos_k = k0 + torch.arange(kb.shape[1], device=dev)
            s = torch.where(_mask(pos_q, pos_k, causal, window), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        blk = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + n] = blk.permute(0, 3, 1, 2, 4).reshape(
            B, n, H, Dv).to(q.dtype)
        if return_lse:
            lse[:, :, q0:q0 + n] = torch.where(
                m == NEG_INF, torch.inf, m + torch.log(l)).reshape(B, H, n)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True,
                            window=None, cap=None, scale=None, q_offset=0,
                            q_blk: int = 256):
    """The gradients ``(dq, dk, dv)`` (float32, in q's, k's and v's
    shapes) of :func:`flash_attention_ref`'s output for ``dout``, from its
    ``out`` and ``lse``."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, KH, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, KH, Dv), dtype=torch.float32, device=dev)
    pos_k = torch.arange(Sk, device=dev)
    for q0 in range(0, Sq, max(1, q_blk)):
        qb = q[:, q0:q0 + q_blk].float()
        n = qb.shape[1]
        qg = qb.reshape(B, n, KH, G, D)
        go = dout[:, q0:q0 + n].float().reshape(B, n, KH, G, Dv)
        ob = out[:, q0:q0 + n].float().reshape(B, n, KH, G, Dv)
        L = lse[:, :, q0:q0 + n].reshape(B, KH, G, n)
        delta = (go * ob).sum(-1).permute(0, 2, 3, 1)         # [B,KH,G,n]
        x = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        dy = torch.ones_like(x)
        if cap is not None:
            t = torch.tanh(x / cap)
            x, dy = t * cap, 1 - t * t
        pos_q = q_offset + q0 + torch.arange(n, device=dev)
        mask = _mask(pos_q, pos_k, causal, window)
        p = torch.where(mask, torch.exp(x - L[..., None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", go, vf)
        ds = p * (dp - delta[..., None]) * dy * scale
        dq[:, q0:q0 + n] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(
            B, n, H, D)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
        # a row with no visible key (lse +inf) is the mean of V: each key
        # takes its dO / Sk
        nokey = torch.isinf(L)[..., None].float() / Sk          # [B,KH,G,n,1]
        p = p + nokey
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, go)
    return dq, dk, dv


def attention_ref(q, k, v, *, causal=True, window=None, cap=None,
                  scale=None):
    """q ``[B, H, Sq, D]``; k/v ``[B, KH, Sk, D(v)]`` → ``[B, H, Sq, Dv]``
    float32 (dense softmax)."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = torch.repeat_interleave(k, G, dim=1).float()
    vr = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    pos_q = torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    s = torch.where(_mask(pos_q, pos_k, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)
