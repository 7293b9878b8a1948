"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + MoE
64 routed top-6 + 2 shared experts; first layer dense (hf config)."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    vocab_size=102_400,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,                # qk_nope(128) + qk_rope(64)
    d_ff=10_944,                 # dense prefix layer (hf first_k_dense_replace=1)
    prefix=(("attn:global", "dense"),),
    pattern=(("attn:global", "moe"),),
    attn_type="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    norm_topk=False,             # v2-lite: unnormalized top-k weights
    rope_theta=10_000.0,
    source="arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite "
           "(assignment header '64e top-6'; '160 routed' applies to full V2 — "
           "see DESIGN.md §8)",
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=3,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=4,
    head_dim=24,
    d_ff=192,
    prefix=(("attn:global", "dense"),),
    pattern=(("attn:global", "moe"),),
    attn_type="mla",
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    capacity_factor=16.0,  # no-drop capacity for decode-equivalence smoke tests
    num_experts=8,
    experts_per_token=3,
    num_shared_experts=2,
    moe_d_ff=48,
    norm_topk=False,
)

register(CONFIG, SMOKE)
