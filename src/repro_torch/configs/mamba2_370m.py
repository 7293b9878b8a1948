"""Mamba2-370m [arXiv:2405.21060]: pure SSM (SSD), attention-free."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50_280,
    pattern=(("mamba", "none"),),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.21060 (state-space duality)",
)

SMOKE = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=4,
    d_model=64,
    vocab_size=512,
    pattern=(("mamba", "none"),),
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    tie_embeddings=True,
)

register(CONFIG, SMOKE)
