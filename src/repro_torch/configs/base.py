"""Architecture configuration schema + registry.

Each assigned architecture gets one module in ``repro/configs/<id>.py``
exporting ``CONFIG`` (the exact assigned numbers) and ``SMOKE`` (a reduced
same-family variant for CPU smoke tests).  Layer structure is described by a
*period pattern*: a tuple of ``(mixer, ffn)`` descriptors that tiles the depth
(plus optional non-tiled prefix layers), which is what lets the model
assembler ``lax.scan`` over homogeneous periods — the key to bounded HLO size
and compile time at 512 devices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

LayerSpec = Tuple[str, str]  # (mixer, ffn): mixer ∈ attn:global|attn:local|mamba
                             #               ffn   ∈ dense|moe|none

_REGISTRY: Dict[str, "ArchConfig"] = {}
_SMOKE: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    mlp_type: str = "gated_silu"
    # layer structure
    pattern: Tuple[LayerSpec, ...] = (("attn:global", "dense"),)
    prefix: Tuple[LayerSpec, ...] = ()
    # attention
    attn_type: str = "gqa"           # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    use_post_norm: bool = False
    embed_scale: bool = False
    # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    router_aux_weight: float = 0.01
    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    # structure / modality
    is_encoder: bool = False
    causal: bool = True
    modality: str = "text"           # text | audio_stub | vision_stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # vocab padding for sharded execution (pjit arguments must divide the
    # mesh axes; the launcher sets 256 = lcm of both axes, tests keep 1)
    vocab_pad_multiple: int = 1
    # provenance
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        body = self.num_layers - len(self.prefix)
        assert body % self.period == 0, (self.name, body, self.period)
        return body // self.period

    @property
    def uses_attention(self) -> bool:
        specs = self.pattern + self.prefix
        return any(m.startswith("attn") for m, _ in specs)

    @property
    def uses_mamba(self) -> bool:
        specs = self.pattern + self.prefix
        return any(m == "mamba" for m, _ in specs)

    @property
    def uses_moe(self) -> bool:
        specs = self.pattern + self.prefix
        return any(f == "moe" for _, f in specs)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: decode state per token is O(1) or the
        arch is hybrid (bounded attention share)."""
        return self.uses_mamba

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings and not self.is_encoder:
            total += d * self.vocab_size
        if self.is_encoder:
            total += d * self.vocab_size  # classifier head
        def attn_params() -> int:
            if self.attn_type == "mla":
                qd = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                return (d * qd + d * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.num_heads
                        * (self.qk_nope_dim + self.v_head_dim)
                        + self.num_heads * self.v_head_dim * d)
            hd, khd = self.num_heads * self.head_dim, self.num_kv_heads * self.head_dim
            return d * hd + 2 * d * khd + hd * d
        def mamba_params() -> int:
            d_inner = self.ssm_expand * d
            gn = self.ssm_groups * self.ssm_state
            return (2 * d * d_inner + 2 * d * gn
                    + d * (d_inner // self.ssm_headdim) + d_inner * d)
        def ffn_params(kind: str) -> int:
            if kind == "dense":
                mult = 3 if self.mlp_type.startswith("gated") else 2
                return mult * d * self.d_ff
            if kind == "moe":
                e = 3 * d * self.moe_d_ff
                return (self.num_experts * e + self.num_shared_experts * e
                        + d * self.num_experts)
            return 0
        for mixer, ffn in list(self.prefix) + list(self.pattern) * self.num_periods:
            total += attn_params() if mixer.startswith("attn") else mamba_params()
            total += ffn_params(ffn)
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only k experts count)."""
        if not self.uses_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        specs = list(self.prefix) + list(self.pattern) * self.num_periods
        n_moe = sum(1 for _, f in specs if f == "moe")
        e = 3 * d * self.moe_d_ff
        inactive = n_moe * (self.num_experts - self.experts_per_token) * e
        return full - inactive


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ArchConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY.keys())


def _ensure_loaded():
    # import side-effect registration of all assigned architectures
    from . import (  # noqa: F401
        deepseek_v2_lite_16b, phi35_moe_42b, jamba15_large_398b, mamba2_370m,
        yi_9b, starcoder2_15b, yi_34b, gemma2_9b, hubert_xlarge, qwen2_vl_7b,
    )
