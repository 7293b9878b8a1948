"""Gemma-2 9B [arXiv:2408.00118]: local/global alternating attention,
logit soft-capping, sandwich norms, tied embeddings."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    vocab_size=256_000,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14_336,
    mlp_type="gated_gelu",
    pattern=(("attn:local", "dense"), ("attn:global", "dense")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2408.00118; hf google/gemma-2-9b",
)

SMOKE = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=4,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=192,
    mlp_type="gated_gelu",
    pattern=(("attn:local", "dense"), ("attn:global", "dense")),
    sliding_window=16,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)

register(CONFIG, SMOKE)
