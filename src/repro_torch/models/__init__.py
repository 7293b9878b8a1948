"""LM model substrate: GQA and MLA attention (the flash kernel on the
card), the Mamba-2 SSD mixer, MoE with dual dispatch paths (the
dispatch/combine kernels on the card), and the period-patterned
transformer assembly.  The counterpart of ``src/repro/models``."""
from .transformer import (
    cross_entropy_loss,
    decode_step,
    forward,
    init_cache,
    init_model,
    model_input_dtypes,
    prefill,
)

__all__ = [
    "cross_entropy_loss", "decode_step", "forward", "init_cache",
    "init_model", "model_input_dtypes", "prefill",
]
