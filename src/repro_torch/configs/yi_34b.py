"""Yi-34B [arXiv:2403.04652; hf]: llama-arch dense GQA."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    vocab_size=64_000,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    rope_theta=10_000.0,
    source="arXiv:2403.04652; hf 01-ai/Yi-34B",
)

SMOKE = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
)

register(CONFIG, SMOKE)
