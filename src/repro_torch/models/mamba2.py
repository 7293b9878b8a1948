"""Mamba-2 (SSD, arXiv:2405.21060) in the chunked matmul ("state-space
duality") form.

The counterpart of ``src/repro/models/mamba2.py``, which computes all of
this outside any Pallas kernel; the port is plain PyTorch.  The sequence is
kept as chunk × intra-chunk axes: the intra-chunk terms are dense masked
products over every chunk at once, and only the O(S/chunk) recurrence of
the float32 state from chunk to chunk is a loop.  Decode is the O(1) state
update, with no KV cache.

Layout conventions (the reference's):
  x-in   [B, S, H, P]    (H = d_inner/headdim heads, P = headdim)
  dt     [B, S, H]
  A      [H]             (negative; A = -exp(a_log))
  B, C   [B, S, G, N]    (G groups broadcast over heads, N = ssm_state)
  state  [B, H, P, N]    (float32 under any weight dtype)
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .pspec import constrain
from .common import init_dense, init_rmsnorm, rmsnorm

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode", "ssd_scan",
           "ssd_ref", "ssd_step"]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_scan(x, dt, A, B, C, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  Returns ``(y [B,S,H,P] in x's dtype, final_state
    [B,H,P,N] float32)``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc, reps = s // chunk, h // g
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, g, n)
    Cc = C.float().reshape(b, nc, chunk, g, n)
    dA_cum = torch.cumsum(dtc * A, dim=2)                  # [b,c,l,h]
    dA_sum = dA_cum[:, :, -1, :]                           # [b,c,h]

    # intra-chunk: a masked "attention-like" product over positions, with
    # heads h = g·reps + r as in the reference's repeat over groups
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)        # [b,c,g,i,j]
    decay = torch.exp(dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :])
    decay = torch.where(tril[:, :, None], decay, 0.0)      # [b,c,i,j,h]
    Gmat = (CB.repeat_interleave(reps, dim=2)
            * decay.permute(0, 1, 4, 2, 3)
            * dtc.permute(0, 1, 3, 2)[:, :, :, None, :])   # [b,c,h,i,j]
    y = torch.einsum("bchij,bcjhp->bcihp", Gmat, xc)

    # each chunk's own contribution to the state at its end
    ds = torch.exp(dA_sum[:, :, None, :] - dA_cum) * dtc   # [b,c,l,h]
    dsx = (ds[..., None] * xc).reshape(b, nc, chunk, g, reps, p)
    inc = torch.einsum("bclgn,bclgrp->bcgrpn", Bc, dsx).reshape(
        b, nc, h, p, n)

    # the recurrence: the state entering each chunk, then the final one
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    decay_chunk = torch.exp(dA_sum)[..., None, None]       # [b,c,h,1,1]
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay_chunk[:, c] * state + inc[:, c]
    states = torch.stack(entering, dim=1).reshape(b, nc, g, reps, p, n)
    y_inter = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, states).reshape(
        b, nc, chunk, h, p) * torch.exp(dA_cum)[..., None]
    y = (y + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssd_ref(x, dt, A, B, C, init_state=None):
    """Sequential-oracle SSD (one step per position) for tests."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    ys = []
    for t in range(s):
        y, state = ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], state)
        ys.append(y.float())
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_step(x, dt, A, B, C, state):
    """One decode step.  x ``[B,H,P]``, dt ``[B,H]``, B/C ``[B,G,N]``,
    state ``[B,H,P,N]`` (float32) → ``(y [B,H,P], state)``."""
    h = x.shape[1]
    reps = h // B.shape[1]
    dtf = dt.float()
    dA = torch.exp(dtf * A)
    Bt = B.float().repeat_interleave(reps, dim=1)
    Ct = C.float().repeat_interleave(reps, dim=1)
    inc = dtf[:, :, None, None] * x.float()[..., None] * Bt[:, :, None, :]
    state = dA[:, :, None, None] * state + inc
    y = torch.einsum("bhpn,bhn->bhp", state, Ct)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_ch = d_inner + 2 * g * n
    return d_inner, nheads, g, n, conv_ch


def init_mamba2(gen, cfg, dtype=torch.float32, device=None):
    """Random Mamba-2 parameters from ``gen``; ``dt_bias``, ``a_log`` and
    ``d_skip`` stay float32 under any ``dtype``, as in the reference."""
    d = cfg.d_model
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    f32 = torch.float32

    def uniform(k):
        return torch.rand((k,), generator=gen, dtype=f32, device=device)

    dt_floor = 1e-3
    dt_init = torch.exp(uniform(nheads) * (math.log(0.1) - math.log(dt_floor))
                        + math.log(dt_floor))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=gen, dtype=f32,
                         device=device) / math.sqrt(cfg.conv_width)
    return {
        "wz": init_dense(gen, d, d_inner, dtype, device),
        "wx": init_dense(gen, d, d_inner, dtype, device),
        "wb": init_dense(gen, d, g * n, dtype, device),
        "wc": init_dense(gen, d, g * n, dtype, device),
        "wdt": init_dense(gen, d, nheads, dtype, device),
        "dt_bias": dt_bias,
        "a_log": torch.log(1.0 + 15.0 * uniform(nheads)),
        "d_skip": torch.ones((nheads,), dtype=f32, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "norm": init_rmsnorm(d_inner, dtype, device),
        "wo": init_dense(gen, d_inner, d, dtype, device),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv by shifted adds.  u ``[B,S,C]``, w ``[W,C]``,
    b ``[C]``."""
    W = w.shape[0]
    out = u * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :u.shape[1], :]
        out = out + shifted * w[W - 1 - i]
    return F.silu(out + b)


def mamba2_forward(params, x, cfg, *, chunk: int = 128,
                   seq_chunk: int = 2048):
    """x ``[B,S,d]`` → ``(y [B,S,d], (conv_state [B,W-1,C], ssd_state
    [B,H,P,N]))`` for cache priming.  The sequence goes through in pieces
    of ``seq_chunk``, the conv's tail and the state carried between them,
    so the peak memory does not grow with S."""
    B_, S, _ = x.shape
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    W = cfg.conv_width
    A = -torch.exp(params["a_log"])
    seq_chunk = min(seq_chunk, S)
    if S % seq_chunk:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"seq_chunk {seq_chunk}")
    conv_tail = torch.zeros((B_, W - 1, conv_ch), dtype=x.dtype,
                            device=x.device)
    state = torch.zeros((B_, nheads, cfg.ssm_headdim, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for start in range(0, S, seq_chunk):
        xc = x[:, start:start + seq_chunk]
        z = xc @ params["wz"]
        u_new = torch.cat([xc @ params["wx"], xc @ params["wb"],
                           xc @ params["wc"]], dim=-1)
        u_ext = torch.cat([conv_tail, u_new], dim=1)      # [B, W-1+sc, C]
        conv_out = u_ext[:, W - 1:, :] * params["conv_w"][W - 1]
        for i in range(1, W):
            conv_out = conv_out + (u_ext[:, W - 1 - i:-i, :]
                                   * params["conv_w"][W - 1 - i])
        conv_out = F.silu(conv_out + params["conv_b"])
        conv_tail = u_ext[:, -(W - 1):, :]
        xin, Bssm, Cssm = torch.split(conv_out, [d_inner, g * n, g * n],
                                      dim=-1)
        dt = F.softplus((xc @ params["wdt"]).float() + params["dt_bias"])
        xh = xin.reshape(B_, seq_chunk, nheads, cfg.ssm_headdim)
        y, state = ssd_scan(xh, dt, A, Bssm.reshape(B_, seq_chunk, g, n),
                            Cssm.reshape(B_, seq_chunk, g, n), chunk=chunk,
                            init_state=state)
        y = y + params["d_skip"][:, None].to(y.dtype) * xh
        y = y.reshape(B_, seq_chunk, d_inner)
        y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
        ys.append(y @ params["wo"])
    return torch.cat(ys, dim=1), (conv_tail, state)


def mamba2_decode(params, x, cfg, conv_state, ssd_state):
    """One token.  x ``[B,1,d]``; conv_state ``[B,W-1,C]``; ssd_state
    ``[B,H,P,N]`` → ``(y [B,1,d], (new conv_state, new ssd_state))``, new
    tensors (the caller stores them)."""
    B_ = x.shape[0]
    d_inner, nheads, g, n, conv_ch = _dims(cfg)
    xt = x[:, 0, :]
    z = xt @ params["wz"]
    # each product laid out alike first: on a mesh DTensor cannot join a
    # batch-split piece with a partial sum
    u_new = torch.cat([constrain(xt @ params[w], "dp", None)
                       for w in ("wx", "wb", "wc")], dim=-1)
    window = torch.cat([conv_state, u_new[:, None, :]], dim=1)  # [B,W,C]
    conv_out = F.silu(
        torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
        + params["conv_b"].float()).to(x.dtype)
    xin, Bssm, Cssm = torch.split(conv_out, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus((xt @ params["wdt"]).float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])
    xh = xin.reshape(B_, nheads, cfg.ssm_headdim)
    y, ssd_state = ssd_step(xh, dt, A, Bssm.reshape(B_, g, n),
                            Cssm.reshape(B_, g, n), ssd_state)
    y = y + params["d_skip"][:, None].to(y.dtype) * xh
    y = rmsnorm(params["norm"], y.reshape(B_, d_inner) * F.silu(z),
                cfg.norm_eps)
    return (y @ params["wo"])[:, None, :], (window[:, 1:, :], ssd_state)
