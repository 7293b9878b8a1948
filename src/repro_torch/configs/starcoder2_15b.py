"""StarCoder2-15B [arXiv:2402.19173; hf]: dense GQA, RoPE, non-gated GELU MLP."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    vocab_size=49_152,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    mlp_type="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    source="arXiv:2402.19173; hf bigcode/starcoder2-15b",
)

SMOKE = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    mlp_type="gelu",
    qkv_bias=True,
)

register(CONFIG, SMOKE)
