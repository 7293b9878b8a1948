"""Model assembly: period-patterned blocks over depth.

The counterpart of ``src/repro/models/transformer.py``.  Architectures are
a *period pattern* (``configs.base``) of (mixer, ffn) slots tiled
``num_periods`` times, plus optional prefix layers.  The scanned body's
parameters stay stacked on a leading period axis, as in the reference, and
the ``lax.scan`` over periods is a Python loop that indexes that axis.

Three entry points share the block code:
  * ``forward``      — logits (+ MoE aux loss)
  * ``prefill``      — forward that also returns a decode cache
  * ``decode_step``  — one-token step against a preallocated cache

The cache is a nested dict like the reference's, with ``"pos"`` a Python
int; ``decode_step`` writes the new K/V into the cache's tensors in place
and returns the same dict with ``pos`` advanced.  Mamba mixers and MLA are
not ported yet (ROADMAP Queue 1 item 11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import gqa_decode, gqa_forward, init_gqa, init_mla
from .common import (init_dense, init_mlp, init_rmsnorm, mlp, mrope_freqs,
                     randn, rmsnorm, rope, softcap)
from .moe import init_moe, moe_forward

__all__ = ["init_model", "forward", "prefill", "decode_step", "init_cache",
           "cross_entropy_loss", "model_input_dtypes"]


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item 11")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.uses_mamba:
        raise _unported(f"{cfg.name}'s mamba2 mixer")
    if cfg.attn_type == "mla":
        raise _unported(f"{cfg.name}'s MLA attention")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_slot(gen, cfg: ArchConfig, spec, dtype, device):
    mixer, ffn = spec
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, device)}
    if mixer == "mamba":
        raise _unported("the mamba2 mixer")
    if cfg.attn_type == "mla":
        p["mixer"] = init_mla(gen, cfg, dtype, device)
    else:
        p["mixer"] = init_gqa(gen, cfg, dtype, device)
    if ffn != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, device)
        if ffn == "moe":
            p["ffn"] = init_moe(gen, cfg, dtype, device)
        else:
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                                dtype, device)
    if cfg.use_post_norm:
        p["postnorm1"] = init_rmsnorm(cfg.d_model, dtype, device)
        if ffn != "none":
            p["postnorm2"] = init_rmsnorm(cfg.d_model, dtype, device)
    return p


def _init_period(gen, cfg: ArchConfig, dtype, device):
    return {f"s{i}": _init_slot(gen, cfg, spec, dtype, device)
            for i, spec in enumerate(cfg.pattern)}


def _stack_into(dst, src, i: int):
    """Copy one period's params into slice ``i`` of the stacked tree."""
    for key, val in src.items():
        if isinstance(val, dict):
            _stack_into(dst[key], val, i)
        else:
            dst[key][i].copy_(val)


def _empty_stacked(src, n: int):
    return {key: (_empty_stacked(val, n) if isinstance(val, dict)
                  else torch.empty((n,) + tuple(val.shape), dtype=val.dtype,
                                   device=val.device))
            for key, val in src.items()}


def init_model(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
               device=None):
    """Random parameters drawn from ``gen`` (which must live on
    ``device``'s type), built on ``device`` (CUDA by default).  Stacked
    period params are filled one period at a time, so the peak is the
    model plus one period."""
    dev = resolve_device(device)
    _check_supported(cfg)
    params: Dict[str, Any] = {}
    if cfg.modality == "audio_stub":
        # frame embeddings arrive precomputed at d_model: input proj + norm
        params["frontend"] = {
            "proj": init_dense(gen, cfg.d_model, cfg.d_model, dtype, dev),
            "norm": init_rmsnorm(cfg.d_model, dtype, dev)}
    else:
        params["embed"] = {"table": randn(
            gen, (cfg.padded_vocab, cfg.d_model), dtype, dev, 0.02)}
    if cfg.prefix:
        params["prefix"] = {f"p{i}": _init_slot(gen, cfg, spec, dtype, dev)
                            for i, spec in enumerate(cfg.prefix)}
    if cfg.num_periods:
        stacked = None
        for i in range(cfg.num_periods):
            one = _init_period(gen, cfg, dtype, dev)
            if stacked is None:
                stacked = _empty_stacked(one, cfg.num_periods)
            _stack_into(stacked, one, i)
            del one
        params["blocks"] = stacked
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype, dev)
    return params


def _period(tree, i: int):
    """Period ``i``'s slice of the stacked params (views, no copies)."""
    return {key: (_period(val, i) if isinstance(val, dict) else val[i])
            for key, val in tree.items()}


# ---------------------------------------------------------------------------
# shared block application
# ---------------------------------------------------------------------------

def _mixer_window(cfg, mixer):
    return cfg.sliding_window if mixer == "attn:local" else None


def _apply_slot(p, cfg: ArchConfig, spec, x, sin, cos, *, moe_dispatch,
                moe_budget, moe_token_chunk, q_chunk, kv_chunk):
    """Full-sequence slot application. Returns (x, cache_entry, aux)."""
    mixer, ffn = spec
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, (k, v) = gqa_forward(p["mixer"], h, cfg, sin, cos,
                              window=_mixer_window(cfg, mixer),
                              is_causal=cfg.causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    cache_entry = {"k": k, "v": v}
    if cfg.use_post_norm:
        out = rmsnorm(p["postnorm1"], out, cfg.norm_eps)
    x = x + out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if ffn == "moe":
            out, aux = moe_forward(p["ffn"], h, cfg, dispatch=moe_dispatch,
                                   budget_bytes=moe_budget,
                                   token_chunk=moe_token_chunk)
        else:
            out = mlp(p["ffn"], h, cfg.mlp_type)
        if cfg.use_post_norm:
            out = rmsnorm(p["postnorm2"], out, cfg.norm_eps)
        x = x + out
    return x, cache_entry, aux


def _rope_tables(cfg: ArchConfig, batch, seq_len, device, q_offset=0):
    if cfg.mrope_sections:
        return mrope_freqs(batch["positions"], cfg.head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    positions = (torch.arange(seq_len, device=device) + q_offset)[None, :]
    return rope(positions, cfg.head_dim, cfg.rope_theta)


def _embed(params, cfg: ArchConfig, batch):
    if cfg.modality == "audio_stub":
        f = params["frontend"]
        x = rmsnorm(f["norm"], batch["features"] @ f["proj"], cfg.norm_eps)
    else:
        x = params["embed"]["table"][batch["tokens"].long()]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head(params, cfg: ArchConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = x @ params["lm_head"]
    logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.where(torch.arange(cfg.padded_vocab,
                                       device=logits.device)
                          >= cfg.vocab_size, -1e30, 0.0)
        logits = (logits.float() + pad).to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# forward (eval / prefill)
# ---------------------------------------------------------------------------

def forward(params, cfg: ArchConfig, batch, *, collect_cache: bool = False,
            moe_dispatch: str = "auto", moe_budget: int = 2 << 30,
            moe_token_chunk: int = 32_768, q_chunk: int = 256,
            kv_chunk: int = 1024, return_hidden: bool = False):
    """batch: {"tokens": [B,S]} | {"features": [B,S,d]} (+ "positions" for
    M-RoPE).  Returns (logits [B,S,V], aux_loss, cache|None)."""
    _check_supported(cfg)
    x = _embed(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    sin, cos = _rope_tables(cfg, batch, S, x.device)
    apply_kw = dict(moe_dispatch=moe_dispatch, moe_budget=moe_budget,
                    moe_token_chunk=moe_token_chunk,
                    q_chunk=q_chunk, kv_chunk=kv_chunk)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prefix_cache = {}
    for i, spec in enumerate(cfg.prefix):
        x, entry, aux = _apply_slot(params["prefix"][f"p{i}"], cfg, spec, x,
                                    sin, cos, **apply_kw)
        aux_total = aux_total + aux
        if collect_cache:
            prefix_cache[f"p{i}"] = entry

    block_cache = None
    if cfg.num_periods:
        entries = {f"s{i}": [] for i in range(cfg.period)}
        for n in range(cfg.num_periods):
            period_params = _period(params["blocks"], n)
            for i, spec in enumerate(cfg.pattern):
                x, entry, aux = _apply_slot(period_params[f"s{i}"], cfg,
                                            spec, x, sin, cos, **apply_kw)
                aux_total = aux_total + aux
                if collect_cache:
                    entries[f"s{i}"].append(entry)
        if collect_cache:
            block_cache = {
                slot: {name: torch.stack([e[name] for e in per])
                       for name in per[0]}
                for slot, per in entries.items()}

    logits = x if return_hidden else _head(params, cfg, x)
    cache = None
    if collect_cache:
        cache = {"prefix": prefix_cache, "blocks": block_cache, "pos": S}
    return logits, aux_total, cache


def prefill(params, cfg: ArchConfig, batch, **kw):
    """Forward returning (last-token logits, cache) — the serving prefill.
    The head is applied to the LAST position only."""
    hidden, _, cache = forward(params, cfg, batch, collect_cache=True,
                               return_hidden=True, **kw)
    logits = _head(params, cfg, hidden[:, -1:, :])
    return logits[:, 0, :], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.float32, device=None):
    """Preallocated decode cache (zeros), laid out as forward's
    collect_cache tree, with attention entries fixed at ``max_seq``."""
    dev = resolve_device(device)
    _check_supported(cfg)

    def slot_cache(lead=()):
        shape = lead + (batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    cache: Dict[str, Any] = {
        "prefix": {f"p{i}": slot_cache() for i in range(len(cfg.prefix))},
        "blocks": None,
        "pos": 0,
    }
    if cfg.num_periods:
        cache["blocks"] = {f"s{i}": slot_cache((cfg.num_periods,))
                           for i in range(cfg.period)}
    return cache


def _decode_slot(p, cfg: ArchConfig, spec, x, sin, cos, cache_entry,
                 pos: int):
    mixer, ffn = spec
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, (k_c, v_c) = gqa_decode(p["mixer"], h, cfg, sin, cos,
                                 cache_entry["k"], cache_entry["v"], pos,
                                 window=_mixer_window(cfg, mixer))
    if cfg.use_post_norm:
        out = rmsnorm(p["postnorm1"], out, cfg.norm_eps)
    x = x + out
    if ffn != "none":
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if ffn == "moe":
            out, _ = moe_forward(p["ffn"], h, cfg, dispatch="einsum")
        else:
            out = mlp(p["ffn"], h, cfg.mlp_type)
        if cfg.use_post_norm:
            out = rmsnorm(p["postnorm2"], out, cfg.norm_eps)
        x = x + out
    return x, {"k": k_c, "v": v_c}


def decode_step(params, cfg: ArchConfig, cache, batch):
    """One decode step.  batch: {"tokens": [B, 1]} (+ "positions" [3,B,1]
    for M-RoPE).  Returns (logits [B, V], cache) with the cache's tensors
    updated in place and ``pos`` advanced."""
    _check_supported(cfg)
    pos = int(cache["pos"])
    x = _embed(params, cfg, batch)
    if cfg.mrope_sections:
        sin, cos = _rope_tables(cfg, batch, 1, x.device)
    else:
        positions = torch.full((1, 1), pos, dtype=torch.int32,
                               device=x.device)
        sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta)

    new_prefix = {}
    for i, spec in enumerate(cfg.prefix):
        x, entry = _decode_slot(params["prefix"][f"p{i}"], cfg, spec, x,
                                sin, cos, cache["prefix"][f"p{i}"], pos)
        new_prefix[f"p{i}"] = entry

    if cfg.num_periods:
        for n in range(cfg.num_periods):
            period_params = _period(params["blocks"], n)
            period_cache = _period(cache["blocks"], n)
            for i, spec in enumerate(cfg.pattern):
                x, _ = _decode_slot(period_params[f"s{i}"], cfg, spec, x,
                                    sin, cos, period_cache[f"s{i}"], pos)

    logits = _head(params, cfg, x)[:, 0, :]
    new_cache = {"prefix": new_prefix, "blocks": cache["blocks"],
                 "pos": pos + 1}
    return logits, new_cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, labels, mask=None):
    """Stable CE.  labels [B,S] int; mask 1.0/0.0 (or labels<0 → masked)."""
    if mask is None:
        mask = (labels >= 0).float()
    labels = torch.clamp_min(labels.long(), 0)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def model_input_dtypes(cfg: ArchConfig):
    """Which inputs this arch consumes."""
    inputs = {}
    if cfg.modality == "audio_stub":
        inputs["features"] = "float32"
    else:
        inputs["tokens"] = "int32"
    if cfg.mrope_sections:
        inputs["positions"] = "int32"
    return inputs
