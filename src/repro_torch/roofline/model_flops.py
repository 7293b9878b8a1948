"""Analytic model flops of a step: the "useful" compute.

The reference's ``roofline/model_flops.py``, formula for formula:
  * parameter products: 2·N_active per token forward, ×3 for training,
    embedding lookups excluded;
  * attention: two products (QKᵀ, PV), 2·S_kv·H·(Dh + Dv) per query token
    per attention layer, halved for a causal mask over the full sequence;
    MLA's Dh is ``qk_nope + qk_rope`` and its Dv ``v_head_dim``;
  * SSD: the intra-chunk products (as attention over the chunk) and the
    state updates, per chunk.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeSpec

__all__ = ["model_flops"]


def _attn_layer_flops(cfg: ArchConfig, s_q: int, s_kv: int,
                      causal_half: bool) -> float:
    if cfg.attn_type == "mla":
        dh = cfg.qk_nope_dim + cfg.qk_rope_dim
        dv = cfg.v_head_dim
    else:
        dh = dv = cfg.head_dim
    f = 2.0 * s_q * s_kv * cfg.num_heads * (dh + dv)
    return f * (0.5 if causal_half else 1.0)


def _layer_counts(cfg: ArchConfig):
    specs = list(cfg.prefix) + list(cfg.pattern) * cfg.num_periods
    n_attn_g = sum(1 for m, _ in specs if m == "attn:global")
    n_attn_l = sum(1 for m, _ in specs if m == "attn:local")
    n_mamba = sum(1 for m, _ in specs if m == "mamba")
    return n_attn_g, n_attn_l, n_mamba


def _ssd_layer_flops(cfg: ArchConfig, s: int, chunk: int = 128) -> float:
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state
    c = min(chunk, s)
    # intra: the C·B product (c×c×n per group) and y_intra (c×c×p per
    # head); inter: the state's two products
    per_chunk = (2 * c * c * cfg.ssm_groups * n
                 + 2 * c * c * h * cfg.ssm_headdim
                 + 2 * c * h * cfg.ssm_headdim * n * 2)
    return (s // c) * per_chunk if c else 0.0


def _mixer_flops(cfg: ArchConfig, s_q: int, s_kv: int, causal_half: bool,
                 ssd_len: int, ssd_chunk: int = 128) -> float:
    n_g, n_l, n_m = _layer_counts(cfg)
    return (n_g * _attn_layer_flops(cfg, s_q, s_kv, causal_half)
            + n_l * _attn_layer_flops(cfg, s_q,
                                      min(s_kv, cfg.sliding_window or s_kv),
                                      causal_half=False)
            + n_m * _ssd_layer_flops(cfg, ssd_len, ssd_chunk))


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Model flops of one step of ``shape`` (train, prefill or decode)
    over its global batch."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return (6.0 * n_active * B * S
                + 3.0 * B * _mixer_flops(cfg, S, S, cfg.causal, S))
    if shape.kind == "prefill":
        return (2.0 * n_active * B * S
                + B * _mixer_flops(cfg, S, S, cfg.causal, S))
    # decode: one token against seq_len of context
    return 2.0 * n_active * B + B * _mixer_flops(cfg, 1, S, False, 1, 1)
