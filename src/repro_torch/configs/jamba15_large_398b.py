"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf]: hybrid Mamba+attention 7:1
interleave, MoE 16e top-2 on every other layer (matches the 398B-total /
94B-active ratio with the assigned d_ff=24576 — DESIGN.md §8).

Deviation note: the substrate's SSM block is Mamba-2 (SSD); Jamba's original
layers are Mamba-1.  The state-size/interleave structure (and everything the
dry-run/roofline measures) is preserved; see DESIGN.md §8.
"""
from .base import ArchConfig, register

_PERIOD = (
    ("attn:global", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    vocab_size=65_536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    pattern=_PERIOD,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24_576,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf ai21labs/AI21-Jamba-1.5-Large",
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=8,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    pattern=_PERIOD,
    capacity_factor=16.0,  # no-drop capacity for decode-equivalence smoke tests
    num_experts=4,
    experts_per_token=2,
    moe_d_ff=128,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
)

register(CONFIG, SMOKE)
