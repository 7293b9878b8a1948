"""Yi-9B [arXiv:2403.04652; hf]: llama-arch dense GQA."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    vocab_size=64_000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    rope_theta=10_000.0,
    source="arXiv:2403.04652; hf 01-ai/Yi-9B",
)

SMOKE = ArchConfig(
    name="yi-9b",
    family="dense",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
)

register(CONFIG, SMOKE)
