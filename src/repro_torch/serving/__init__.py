"""LM serving: prefill/decode step factories, the request scheduler and
greedy generation (the counterpart of ``src/repro/serving``; ``kv_quant``
is not ported yet)."""
