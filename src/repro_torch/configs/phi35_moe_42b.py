"""Phi-3.5-MoE 42B/A6.6B [hf:microsoft/Phi-3.5-MoE-instruct]: 16 experts top-2."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    vocab_size=32_064,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    pattern=(("attn:global", "moe"),),
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    norm_topk=True,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    pattern=(("attn:global", "moe"),),
    capacity_factor=16.0,  # no-drop capacity for decode-equivalence smoke tests
    num_experts=4,
    experts_per_token=2,
    moe_d_ff=96,
)

register(CONFIG, SMOKE)
