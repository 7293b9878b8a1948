"""Shared model components: norms, rotary embeddings (incl. M-RoPE), MLPs.

The counterpart of ``src/repro/models/common.py``.  Modules are plain
functions: ``init_*(gen, ..., dtype, device) -> params`` draws from an
explicit ``torch.Generator`` on ``device``, and ``apply(params, x, ...) ->
y``.  Norms, rotary embeddings and the soft-cap compute in float32 inside
and return the input's dtype, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "init_rmsnorm", "rmsnorm",
    "init_dense", "init_mlp", "mlp",
    "rope", "apply_rope", "mrope_freqs",
    "softcap", "randn",
]


def randn(gen: torch.Generator, shape, dtype, device,
          scale: float = 1.0) -> torch.Tensor:
    """Standard normal draws in float32 from ``gen``, times ``scale``, in
    ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


# -- RMSNorm -----------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + w) parameterization; init scale=0 → identity
    return (xf * (1.0 + params["scale"].float())).to(dt)


# -- Linear / MLP ----------------------------------------------------------

def init_dense(gen, d_in: int, d_out: int, dtype=torch.float32, device=None,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return randn(gen, (d_in, d_out), dtype, device, scale)


def init_mlp(gen, d_model: int, d_ff: int, mlp_type: str,
             dtype=torch.float32, device=None):
    if mlp_type in ("gated_silu", "gated_gelu"):
        return {"wg": init_dense(gen, d_model, d_ff, dtype, device),
                "wi": init_dense(gen, d_model, d_ff, dtype, device),
                "wo": init_dense(gen, d_ff, d_model, dtype, device)}
    if mlp_type == "gelu":
        return {"wi": init_dense(gen, d_model, d_ff, dtype, device),
                "wo": init_dense(gen, d_ff, d_model, dtype, device)}
    raise ValueError(mlp_type)


def mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "gated_silu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif mlp_type == "gated_gelu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * (x @ params["wi"])
    elif mlp_type == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ params["wo"]


# -- Rotary position embeddings ----------------------------------------------

def _inv_freqs(half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> (sin, cos) each [..., S, head_dim//2], f32."""
    freqs = _inv_freqs(head_dim // 2, theta, positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def mrope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL): 3 position streams (t, h, w) own disjoint
    frequency sections.  positions: [3, B, S]; sections sum to head_dim//2."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    freqs = _inv_freqs(half, theta, positions.device)
    angles_all = positions.float()[..., None] * freqs  # [3,B,S,half]
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(angles_all[i, ..., start:start + sec])
        start += sec
    angles = torch.cat(parts, dim=-1)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; sin/cos: [B, S, D//2] (broadcast over heads)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# -- misc -----------------------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)
