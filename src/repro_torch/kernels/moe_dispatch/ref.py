"""Plain PyTorch versions of the MoE dispatch and combine kernels.

:func:`dispatch_ref` and :func:`combine_ref` repeat the arithmetic of the
CUDA kernels in ``csrc/moe_dispatch.cu``: dispatch sums the x rows routed
to each (expert, slot) row in float32, in ascending t (one pass per rank
among the tokens that share a row, so no pass writes a row twice and the
order is fixed on any device), and writes x's dtype; combine multiplies the
row ``buf[eidx_t, slot_t]`` by ``w_t`` cast to buf's dtype, in float32, and
writes buf's dtype (+0.0 for a dropped assignment); :func:`combine_slots_ref`
adds the k routing slots' combines in slot order in buf's dtype, and
:func:`dispatch_slots_ref` is the layer body's dispatch of all k slots.
Assignments outside ``[0, E) x [0, C)`` are dropped.
The wrappers in :mod:`.ops` take them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them on the card.

:func:`combine_weight_grad_ref` is the plain version of the routing-weight
gradient kernel: ``dw[t, j] = Σ_d dy[t, d] · buf[e_tj, s_tj, d]`` in
float32, +0.0 for a dropped assignment.

:func:`dispatch_onehot_ref` is the one-hot oracle of
``src/repro/kernels/moe_dispatch/ref.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dispatch_ref", "combine_ref", "combine_slots_ref",
           "dispatch_slots_ref", "combine_weight_grad_ref",
           "dispatch_onehot_ref"]


def _rows(eidx, slot, E: int, C: int):
    eidx, slot = eidx.long(), slot.long()
    keep = (eidx >= 0) & (eidx < E) & (slot >= 0) & (slot < C)
    return eidx * C + slot, keep


def dispatch_ref(x: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                 num_experts: int, capacity: int) -> torch.Tensor:
    """x ``[T, d]``; eidx/slot ``[T]`` → buf ``[E, C, d]`` in x's dtype."""
    T, d = x.shape
    E, C = num_experts, capacity
    row, keep = _rows(eidx, slot, E, C)
    t = torch.nonzero(keep).flatten()
    row = row[t]
    # rank of each kept token among the earlier tokens of its row
    order = torch.sort(row, stable=True).indices
    sr = row[order]
    first = torch.ones_like(sr, dtype=torch.bool)
    first[1:] = sr[1:] != sr[:-1]
    idx = torch.arange(sr.numel(), device=x.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(row)
    rank[order] = idx - start
    acc = torch.zeros((E * C, d), dtype=torch.float32, device=x.device)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        acc[row[sel]] += x[t[sel]].float()
    return acc.reshape(E, C, d).to(x.dtype)


def combine_ref(buf: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]``; eidx/slot/w ``[T]`` → y ``[T, d]`` in buf's
    dtype."""
    E, C, d = buf.shape
    row, keep = _rows(eidx, slot, E, C)
    src = buf.reshape(E * C, d)[torch.where(keep, row, 0)].float()
    wt = w.to(buf.dtype).float()[:, None]
    return torch.where(keep[:, None], wt * src, 0.0).to(buf.dtype)


def combine_slots_ref(buf: torch.Tensor, topk_idx: torch.Tensor,
                      slot: torch.Tensor,
                      topk_w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]``; topk_idx/slot/topk_w ``[T, k]``, k >= 1 → y
    ``[T, d]``: the layer body's loop over :func:`combine_ref`, each
    partial sum rounded to buf's dtype."""
    if topk_idx.shape[1] < 1:
        raise ValueError("expected at least one routing slot")
    y = None
    for j in range(topk_idx.shape[1]):
        c = combine_ref(buf, topk_idx[:, j], slot[:, j], topk_w[:, j])
        y = c if y is None else y + c
    return y


def combine_weight_grad_ref(dy: torch.Tensor, buf: torch.Tensor,
                            topk_idx: torch.Tensor,
                            slot: torch.Tensor) -> torch.Tensor:
    """dy ``[T, d]``; buf ``[E, C, d]``; topk_idx/slot ``[T, k]`` → dw
    ``[T, k]`` float32."""
    E, C, d = buf.shape
    row, keep = _rows(topk_idx, slot, E, C)                   # [T, k]
    rows = buf.reshape(E * C, d)[torch.where(keep, row, 0)].float()
    dw = torch.einsum("td,tkd->tk", dy.float(), rows)
    return torch.where(keep, dw, 0.0)


def dispatch_onehot_ref(x, eidx, slot, num_experts: int, capacity: int):
    """The reference's one-hot oracle (slots outside [0, capacity) dropped,
    as ``jax.nn.one_hot`` drops them)."""
    keep = (slot >= 0) & (slot < capacity)
    onehot_e = F.one_hot(eidx.long(), num_experts).to(x.dtype)
    onehot_c = F.one_hot(torch.where(keep, slot, capacity).long(),
                         capacity + 1)[:, :capacity].to(x.dtype)
    mask = onehot_e[:, :, None] * onehot_c[:, None, :]
    return torch.einsum("tec,td->ecd", mask, x)


def dispatch_slots_ref(x, topk_idx, slot, num_experts: int, capacity: int,
                       w=None):
    """x ``[T, d]``; topk_idx/slot ``[T, k]``; w ``[T, k]`` in x's dtype or
    None → buf ``[E, C, d]`` in x's dtype: the layer body's dispatch of all
    k routing slots (of ``x · w[:, j]`` where w is given), each slot's rows
    added in with ``index_add_`` into an ``(E·C + 1)``-row buffer whose
    last row takes the dropped assignments.  No shape depends on the data,
    so it runs on the meta device a dry-run plans on.  In the layer each
    (expert, slot) row holds at most one assignment (the slot is the rank
    within the expert), so every row is the one token's row exactly, as
    the kernel writes it."""
    E, C = num_experts, capacity
    row, keep = _rows(topk_idx, slot, E, C)
    dst = torch.where(keep, row, E * C)
    buf = x.new_zeros((E * C + 1, x.shape[1]))
    for j in range(dst.shape[1]):
        buf.index_add_(0, dst[:, j], x if w is None else x * w[:, j:j + 1])
    return buf[:E * C].reshape(E, C, x.shape[1])
