"""LM model substrate: GQA attention (the flash kernel on the card), MoE
with dual dispatch paths (the dispatch/combine kernels on the card), and
the period-patterned transformer assembly.  The counterpart of
``src/repro/models``; MLA and mamba2 are not ported yet."""
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
