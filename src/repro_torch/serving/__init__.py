"""LM serving: prefill/decode step factories, the request scheduler,
greedy generation and the int8 KV cache (the counterpart of
``src/repro/serving``)."""
