"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer.
The conv feature frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings [B, S, d_model]; the backbone predicts
cluster ids (vocab=504) per frame."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    vocab_size=504,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    mlp_type="gelu",
    is_encoder=True,
    causal=False,
    modality="audio_stub",
    source="arXiv:2106.07447 (w2v2-family encoder)",
)

SMOKE = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=2,
    d_model=64,
    vocab_size=56,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    mlp_type="gelu",
    is_encoder=True,
    causal=False,
    modality="audio_stub",
)

register(CONFIG, SMOKE)
