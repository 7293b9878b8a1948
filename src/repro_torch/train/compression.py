"""Gradient compression for the all-reduce: int8 with error feedback.
The counterpart of ``src/repro/train/compression.py``.

Symmetric per-tensor int8 quantization cuts the gradient traffic 4× from
float32; error feedback adds each step's residual back before the next
quantization, so the quantization bias does not accumulate (Seide et al.
/ EF-SGD).  The functions are pure: each returns new tensors.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "decompress_tree", "init_error_state", "apply_error_feedback"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any) -> Any:
    """Each leaf → its ``(q, scale)`` pair."""
    return tree_map(quantize_int8, grads)


def decompress_tree(cgrads: Any) -> Any:
    """The inverse of :func:`compress_tree`: a tree whose leaves are
    ``(q, scale)`` pairs → the dequantized tree."""
    if isinstance(cgrads, tuple) and len(cgrads) == 2 and all(
            isinstance(x, torch.Tensor) for x in cgrads):
        return dequantize_int8(*cgrads)
    if isinstance(cgrads, dict):
        return {k: decompress_tree(v) for k, v in cgrads.items()}
    return type(cgrads)(decompress_tree(v) for v in cgrads)


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def apply_error_feedback(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (quantized-and-restored grads, new error residuals)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    restored = tree_map(lambda c: dequantize_int8(*quantize_int8(c)),
                        corrected)
    new_error = tree_map(lambda c, r: c - r, corrected, restored)
    return restored, new_error
