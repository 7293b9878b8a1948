"""Model assembly: period-patterned blocks over depth.

The counterpart of ``src/repro/models/transformer.py``.  Architectures are
a *period pattern* (``configs.base``) of (mixer, ffn) slots tiled
``num_periods`` times, plus optional prefix layers.  The scanned body's
parameters stay stacked on a leading period axis, as in the reference, and
the ``lax.scan`` over periods is a Python loop that indexes that axis.

Three entry points share the block code:
  * ``forward``      — logits (+ MoE aux loss); ``remat=True`` recomputes
    each period in the backward (``torch.utils.checkpoint``), as the
    reference's ``jax.checkpoint`` over the scanned body does
  * ``prefill``      — forward that also returns a decode cache
  * ``decode_step``  — one-token step against a preallocated cache

Training takes ``hidden_forward`` and ``chunked_softmax_xent``: the head,
the logsumexp and the gold logit per sequence chunk, each chunk recomputed
in the backward, so the ``[B, S, V]`` logits never exist.

The cache is a nested dict like the reference's, with ``"pos"`` a Python
int: ``{"k", "v"}`` for a GQA slot, ``{"ckv"}`` (the compressed latent
beside the rope key) for an MLA slot, ``{"conv", "ssd"}`` (the conv's last
``conv_width - 1`` inputs and the float32 SSD state) for a mamba slot.
``decode_step`` writes the new K/V or ``ckv`` entry at ``pos`` and stores
each mamba slot's new state over the old one, all in the cache's tensors in
place, and returns the same dict with ``pos`` advanced.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import (gqa_decode, gqa_forward, init_gqa, init_mla,
                        mla_decode, mla_forward)
from .common import (init_dense, init_mlp, init_rmsnorm, mlp, mrope_freqs,
                     randn, rmsnorm, rope, softcap)
from .mamba2 import _dims as mamba_dims
from .mamba2 import init_mamba2, mamba2_decode, mamba2_forward
from .moe import init_moe, moe_forward
from ..distributed.sharding import is_dtensor
from .pspec import constrain, with_sharding_constraint

__all__ = ["init_model", "forward", "prefill", "decode_step", "init_cache",
           "cross_entropy_loss", "model_input_dtypes", "hidden_forward",
           "chunked_softmax_xent"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_slot(gen, cfg: ArchConfig, spec, dtype, device):
    mixer, ffn = spec
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, device)}
    if mixer == "mamba":
        p["mixer"] = init_mamba2(gen, cfg, dtype, device)
    elif cfg.attn_type == "mla":
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
    if mixer == "mamba":
        out, (conv_state, ssd_state) = mamba2_forward(p["mixer"], h, cfg)
        cache_entry = {"conv": conv_state, "ssd": ssd_state}
    elif cfg.attn_type == "mla":
        out, ckv = mla_forward(p["mixer"], h, cfg, sin, cos,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
        cache_entry = {"ckv": ckv}
    else:
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


def _rope_dim(cfg: ArchConfig) -> int:
    """The width rotary embeddings turn: MLA's rope part, else the head."""
    return cfg.qk_rope_dim if cfg.attn_type == "mla" else cfg.head_dim


def _rope_tables(cfg: ArchConfig, batch, seq_len, device, q_offset=0):
    if cfg.mrope_sections:
        return mrope_freqs(batch["positions"], _rope_dim(cfg), cfg.rope_theta,
                           cfg.mrope_sections)
    positions = (torch.arange(seq_len, device=device) + q_offset)[None, :]
    return rope(positions, _rope_dim(cfg), cfg.rope_theta)


def _embed(params, cfg: ArchConfig, batch):
    if cfg.modality == "audio_stub":
        f = params["frontend"]
        x = rmsnorm(f["norm"], batch["features"] @ f["proj"], cfg.norm_eps)
    elif is_dtensor(params["embed"]["table"]):
        # DTensor's own embedding rule (the same rows as indexing, whose
        # backward's index_put some DTensor versions cannot lay out)
        x = F.embedding(batch["tokens"].long(), params["embed"]["table"])
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
# forward (train / eval / prefill)
# ---------------------------------------------------------------------------

#: ``remat_policy="dots"`` keeps the matrix products' outputs and
#: recomputes the rest, as ``dots_with_no_batch_dims_saveable`` does
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _remat(fn, remat_policy: str, *args):
    """``fn(*args)`` recomputed in the backward instead of saved."""
    if remat_policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                list(_DOT_OPS))
        return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    if remat_policy != "full":
        raise ValueError(f"remat_policy {remat_policy!r}: full or dots")
    return checkpoint(fn, *args, use_reentrant=False)


def forward(params, cfg: ArchConfig, batch, *, collect_cache: bool = False,
            moe_dispatch: str = "auto", moe_budget: int = 2 << 30,
            moe_token_chunk: int = 32_768, remat: bool = False,
            remat_policy: str = "full", q_chunk: int = 256,
            kv_chunk: int = 1024, return_hidden: bool = False,
            logits_sharding=None):
    """batch: {"tokens": [B,S]} | {"features": [B,S,d]} (+ "positions" for
    M-RoPE).  Returns (logits [B,S,V], aux_loss, cache|None).  With
    ``remat`` each period's activations are recomputed in the backward
    (``remat_policy`` "full", or "dots" to keep the matrix products).
    ``logits_sharding`` (a ``distributed.sharding.NamedSharding``) keeps
    DTensor logits vocab-sharded."""
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

        def period_body(n, x, aux_acc):
            period_params = _period(params["blocks"], n)
            # the residual stream pinned: batch over dp, replicated elsewhere
            x = constrain(x, "dp", None, None)
            out = {}
            for i, spec in enumerate(cfg.pattern):
                x, out[f"s{i}"], aux = _apply_slot(
                    period_params[f"s{i}"], cfg, spec, x, sin, cos,
                    **apply_kw)
                aux_acc = aux_acc + aux
            return constrain(x, "dp", None, None), aux_acc, out

        for n in range(cfg.num_periods):
            if remat:
                x, aux_total, out = _remat(
                    functools.partial(period_body, n), remat_policy, x,
                    aux_total)
            else:
                x, aux_total, out = period_body(n, x, aux_total)
            if collect_cache:
                for slot, entry in out.items():
                    entries[slot].append(entry)
        if collect_cache:
            block_cache = {
                slot: {name: torch.stack([e[name] for e in per])
                       for name in per[0]}
                for slot, per in entries.items()}

    logits = x if return_hidden else with_sharding_constraint(
        _head(params, cfg, x), logits_sharding)
    cache = None
    if collect_cache:
        cache = {"prefix": prefix_cache, "blocks": block_cache, "pos": S}
    return logits, aux_total, cache


def prefill(params, cfg: ArchConfig, batch, **kw):
    """Forward returning (last-token logits, cache) — the serving prefill.
    The head is applied to the LAST position only."""
    kw.pop("logits_sharding", None)
    hidden, _, cache = forward(params, cfg, batch, collect_cache=True,
                               return_hidden=True, **kw)
    logits = _head(params, cfg, hidden[:, -1:, :])
    return logits[:, 0, :], cache


def hidden_forward(params, cfg: ArchConfig, batch, **kw):
    """Forward WITHOUT the head: returns (hidden [B,S,d], aux_loss).
    Training takes this and :func:`chunked_softmax_xent`, so the
    ``[B, S, V]`` logits never exist."""
    kw.pop("logits_sharding", None)
    hidden, aux, _ = forward(params, cfg, batch, return_hidden=True, **kw)
    return hidden, aux


def chunked_softmax_xent(params, cfg: ArchConfig, hidden, labels, *,
                         chunk: int = 512, logits_sharding=None):
    """Mean cross entropy over sequence chunks (labels < 0 masked): the
    head, the logsumexp and the gold logit of one chunk at a time, each
    chunk recomputed in the backward (``torch.utils.checkpoint``), so the
    peak is ``B · chunk · V`` logits instead of ``B · S · V``.  The
    chunks' sums are added in order from 0, as the reference's scan adds
    them.  ``logits_sharding`` keeps each chunk's DTensor logits
    vocab-sharded."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")

    def chunk_nll(xc, lc):
        logits = with_sharding_constraint(_head(params, cfg, xc),
                                          logits_sharding)
        mask = (lc >= 0).float()
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        lab = torch.clamp_min(lc.long(), 0)
        if is_dtensor(lf):
            # a gather from vocab-sharded DTensor logits has no working
            # sharding rule; the reference's one-hot contraction gives the
            # same value (one term, the rest exact zeros)
            gold = (lf * F.one_hot(lab, lf.shape[-1]).to(lf.dtype)).sum(-1)
        else:
            gold = torch.gather(lf, -1, lab[..., None])[..., 0]
        return ((lse - gold) * mask).sum(), mask.sum()

    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        n, c = checkpoint(chunk_nll, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll / torch.clamp_min(cnt, 1.0)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.float32, device=None):
    """Preallocated decode cache (zeros), laid out as forward's
    collect_cache tree, with attention entries fixed at ``max_seq``; the
    SSD state is float32 whatever ``dtype`` is."""
    dev = resolve_device(device)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def slot_cache(spec, lead=()):
        mixer, _ = spec
        if mixer == "mamba":
            _, nheads, _, n, conv_ch = mamba_dims(cfg)
            return {"conv": zeros(lead + (batch_size, cfg.conv_width - 1,
                                          conv_ch)),
                    "ssd": zeros(lead + (batch_size, nheads,
                                         cfg.ssm_headdim, n), torch.float32)}
        if cfg.attn_type == "mla":
            width = cfg.kv_lora_rank + cfg.qk_rope_dim
            return {"ckv": zeros(lead + (batch_size, max_seq, width))}
        shape = lead + (batch_size, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    cache: Dict[str, Any] = {
        "prefix": {f"p{i}": slot_cache(spec)
                   for i, spec in enumerate(cfg.prefix)},
        "blocks": None,
        "pos": 0,
    }
    if cfg.num_periods:
        cache["blocks"] = {f"s{i}": slot_cache(spec, (cfg.num_periods,))
                           for i, spec in enumerate(cfg.pattern)}
    return cache


def _decode_slot(p, cfg: ArchConfig, spec, x, sin, cos, cache_entry,
                 pos: int):
    """One token through a slot; ``cache_entry``'s tensors take the new
    state in place."""
    mixer, ffn = spec
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "mamba":
        out, (conv_s, ssd_s) = mamba2_decode(p["mixer"], h, cfg,
                                             cache_entry["conv"],
                                             cache_entry["ssd"])
        cache_entry["conv"].copy_(conv_s)
        cache_entry["ssd"].copy_(ssd_s)
    elif cfg.attn_type == "mla":
        out, _ = mla_decode(p["mixer"], h, cfg, sin, cos, cache_entry["ckv"],
                            pos)
    else:
        out, _ = gqa_decode(p["mixer"], h, cfg, sin, cos, cache_entry["k"],
                            cache_entry["v"], pos,
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
    return x


def decode_step(params, cfg: ArchConfig, cache, batch):
    """One decode step.  batch: {"tokens": [B, 1]} (+ "positions" [3,B,1]
    for M-RoPE).  Returns (logits [B, V], cache) with the cache's tensors
    updated in place and ``pos`` advanced."""
    pos = int(cache["pos"])
    x = _embed(params, cfg, batch)
    if cfg.mrope_sections:
        sin, cos = _rope_tables(cfg, batch, 1, x.device)
    else:
        positions = torch.full((1, 1), pos, dtype=torch.int32,
                               device=x.device)
        sin, cos = rope(positions, _rope_dim(cfg), cfg.rope_theta)

    for i, spec in enumerate(cfg.prefix):
        x = _decode_slot(params["prefix"][f"p{i}"], cfg, spec, x, sin, cos,
                         cache["prefix"][f"p{i}"], pos)

    if cfg.num_periods:
        for n in range(cfg.num_periods):
            period_params = _period(params["blocks"], n)
            period_cache = _period(cache["blocks"], n)
            for i, spec in enumerate(cfg.pattern):
                x = _decode_slot(period_params[f"s{i}"], cfg, spec, x,
                                 sin, cos, period_cache[f"s{i}"], pos)

    logits = _head(params, cfg, x)[:, 0, :]
    new_cache = {"prefix": cache["prefix"], "blocks": cache["blocks"],
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
