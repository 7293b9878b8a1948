"""Mixture-of-Experts with dual dispatch paths.

The counterpart of ``src/repro/models/moe.py``.  Token→expert dispatch runs
one of two ways, mirroring the paper's linear vs tensor execution paths:

  * **sort path** (``dispatch="sort"``, linear): flatten the (token, expert)
    structure, stably argsort by expert, scatter into a materialized
    ``(E·C, d)`` buffer, run the experts, gather back.  Plain PyTorch.
  * **einsum path** (``dispatch="einsum"``, tensor): (expert, capacity) kept
    as explicit axes.  It runs the layer body
    :func:`repro_torch.kernels.moe_dispatch.ops.moe_dispatch` (the
    reference's ``moe_dispatch_pallas``): the hand-written dispatch and
    combine kernels on the card, their plain versions elsewhere, neither
    of which builds the reference's one-hot mask.
  * ``dispatch="auto"`` compares the one-hot working set ``T·E·C·4`` bytes
    *per device* with ``budget_bytes`` (:func:`select_dispatch_path`): under
    a mesh (the ambient ``with mesh:`` scope) the mask is divided over its
    devices, as in the reference.

Both paths drop the same overflow tokens (identical capacity semantics).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.moe_dispatch import ops as moe_ops
from .common import init_dense, randn
from .pspec import ambient_mesh, constrain

__all__ = ["init_moe", "moe_forward", "select_dispatch_path",
           "DispatchDecision", "capacity_per_expert"]


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    path: str
    reason: str
    onehot_bytes: int
    capacity: int


def capacity_per_expert(num_tokens: int, num_experts: int, k: int,
                        capacity_factor: float) -> int:
    c = int(math.ceil(num_tokens * k * capacity_factor / num_experts))
    # a multiple of 16, as the reference rounds it
    return max(16, -(-c // 16) * 16)


def select_dispatch_path(num_tokens: int, num_experts: int, capacity: int,
                         d_model: int, k: int,
                         budget_bytes: int = 2 << 30,
                         force: Optional[str] = None) -> DispatchDecision:
    """Execution-time path choice from static step shapes (paper §III.C).
    The one-hot working set is evaluated per device: under a mesh the
    ``[T, E, C]`` mask shards over its devices."""
    mesh = ambient_mesh()
    shards = mesh.size() if mesh is not None else 1
    onehot_bytes = num_tokens * num_experts * capacity * 4 // max(1, shards)
    if force in ("sort", "einsum"):
        return DispatchDecision(force, "forced", onehot_bytes, capacity)
    if onehot_bytes > budget_bytes:
        return DispatchDecision(
            "sort",
            f"one-hot dispatch tensor {onehot_bytes/1e9:.2f} GB/device exceeds "
            f"budget {budget_bytes/1e9:.2f} GB — linearized dispatch avoids "
            f"the memory-regime shift",
            onehot_bytes, capacity)
    return DispatchDecision(
        "einsum",
        f"one-hot dispatch tensor {onehot_bytes/1e6:.1f} MB/device fits budget; "
        f"dimension-preserving contraction is MXU-shaped",
        onehot_bytes, capacity)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, dtype=torch.float32, device=None):
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": init_dense(gen, d, E, torch.float32, device),  # f32 router
        "wg": randn(gen, (E, d, ff), dtype, device, scale),
        "wi": randn(gen, (E, d, ff), dtype, device, scale),
        "wo": randn(gen, (E, ff, d), dtype, device, 1.0 / math.sqrt(ff)),
    }
    if cfg.num_shared_experts:
        sh_ff = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {"wg": init_dense(gen, d, sh_ff, dtype, device),
                       "wi": init_dense(gen, d, sh_ff, dtype, device),
                       "wo": init_dense(gen, sh_ff, d, dtype, device)}
    return p


# ---------------------------------------------------------------------------
# routing (common to both paths)
# ---------------------------------------------------------------------------

def _route(params, x_flat, cfg):
    """x_flat [T, d] → (topk_idx [T,k], topk_w [T,k], aux_loss), in
    float32."""
    logits = x_flat.float() @ params["router"]              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    # the k largest, the lower expert first on a tie, as jax.lax.top_k picks
    # them (torch.topk may pick another expert of a tie)
    topk_p, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_idx = topk_p[:, :k], topk_idx[:, :k]
    if cfg.norm_topk:
        topk_w = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    else:
        topk_w = topk_p
    # Switch-style load-balance loss
    E = cfg.num_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(topk_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_weight
    return topk_idx, topk_w, aux


def _expert_ffn(params, buf, cfg):
    """buf [E, C, d] → [E, C, d] via the per-expert gated FFN.  Under a
    mesh each expert's weights are gathered whole on its ``"model"`` rank
    (FSDP's ``"data"`` shards joined once a use), as the reference pins
    them, instead of keeping ``d`` split and reducing the ``(E, C, ff)``
    activation over ``"data"``."""
    wg = constrain(params["wg"], "model", None, None)
    wi = constrain(params["wi"], "model", None, None)
    wo = constrain(params["wo"], "model", None, None)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * \
        torch.einsum("ecd,edf->ecf", buf, wi)
    return torch.einsum("ecf,efd->ecd", h, wo)


# ---------------------------------------------------------------------------
# the two dispatch paths
# ---------------------------------------------------------------------------

def _dispatch_einsum(params, x_flat, topk_idx, topk_w, cfg, capacity):
    """TENSOR path: the layer body of the kernels' ops (the kernels on the
    card, their plain versions elsewhere, DTensors through ``local_map``)."""
    return moe_ops.moe_dispatch(params, x_flat, topk_idx, topk_w, cfg,
                                capacity, _expert_ffn)


def _dispatch_sort(params, x_flat, topk_idx, topk_w, cfg, capacity):
    """LINEAR path: flatten + stable argsort by expert + materialized
    (E·C, d) buffer."""
    T, d = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = x_flat.device
    flat_e = topk_idx.reshape(-1)
    flat_w = topk_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    w_sorted = flat_w[order]
    start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                               side="left")
    pos = torch.arange(T * k, device=dev) - start[e_sorted]
    keep = pos < capacity
    slot = e_sorted * capacity + torch.where(keep, pos, 0)
    gathered = x_flat[t_sorted] * keep[:, None].to(x_flat.dtype)
    buf = torch.zeros((E * capacity, d), dtype=x_flat.dtype, device=dev)
    buf.index_add_(0, slot, gathered)
    out_buf = _expert_ffn(params, buf.reshape(E, capacity, d), cfg)
    y_sorted = out_buf.reshape(E * capacity, d)[slot]
    y_sorted = y_sorted * (w_sorted.to(x_flat.dtype)
                           * keep.to(x_flat.dtype))[:, None]
    y = torch.zeros((T, d), dtype=x_flat.dtype, device=dev)
    return y.index_add_(0, t_sorted, y_sorted)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _moe_tokens(params, x_flat, cfg, dispatch: str, budget_bytes: int):
    """Core MoE over a flat token block [T, d] → (y [T, d], aux)."""
    T, d = x_flat.shape
    topk_idx, topk_w, aux = _route(params, x_flat, cfg)
    capacity = capacity_per_expert(T, cfg.num_experts, cfg.experts_per_token,
                                   cfg.capacity_factor)
    decision = select_dispatch_path(
        T, cfg.num_experts, capacity, d, cfg.experts_per_token,
        budget_bytes=budget_bytes,
        force=None if dispatch == "auto" else dispatch)
    if decision.path == "einsum":
        y = _dispatch_einsum(params, x_flat, topk_idx, topk_w, cfg, capacity)
    else:
        y = _dispatch_sort(params, x_flat, topk_idx, topk_w, cfg, capacity)
    if "shared" in params:
        sh = params["shared"]
        h = F.silu(x_flat @ sh["wg"]) * (x_flat @ sh["wi"])
        y = y + h @ sh["wo"]
    return y, aux


def moe_forward(params, x, cfg, *, dispatch: str = "auto",
                budget_bytes: int = 2 << 30,
                token_chunk: int = 32_768) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x [B, S, d] → (y [B, S, d], aux_loss scalar).

    Token blocks above ``token_chunk`` are processed chunk by chunk along S
    (capacity and drops become per-chunk), as the reference's scan does."""
    B, S, d = x.shape
    sc = max(1, token_chunk // B)
    if S > sc and S % sc == 0:
        nc = S // sc
        ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            xc = x[:, i * sc:(i + 1) * sc].reshape(B * sc, d)
            y, a = _moe_tokens(params, xc, cfg, dispatch, budget_bytes)
            aux = aux + a
            ys.append(y.reshape(B, sc, d))
        return torch.cat(ys, dim=1), aux / nc
    # the tokens' gradient kept split like the batch, so the reshape back
    # to [B, S, d] can take it on a mesh
    x_flat = constrain(x.reshape(B * S, d), "dp", None)
    y, aux = _moe_tokens(params, x_flat, cfg, dispatch, budget_bytes)
    return y.reshape(B, S, d), aux
