"""Qwen2-VL-7B [arXiv:2409.12191; hf]: text backbone with M-RoPE.
The vision frontend (dynamic-resolution patch encoder) is a STUB per the
assignment: ``input_specs()`` provides token ids plus 3-stream (t, h, w)
M-RoPE position ids."""
from .base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    vocab_size=152_064,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    modality="vision_stub",
    source="arXiv:2409.12191; hf Qwen/Qwen2-VL-7B-Instruct",
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=192,
    qkv_bias=True,
    mrope_sections=(4, 6, 6),
    modality="vision_stub",
)

register(CONFIG, SMOKE)
