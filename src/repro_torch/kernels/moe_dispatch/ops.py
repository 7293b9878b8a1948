"""MoE dispatch and combine over torch tensors.

The contracts are those of ``src/repro/kernels/moe_dispatch/ops.py``:
``dispatch(x, eidx, slot, E, C)``, ``combine(buf, eidx, slot, w)`` and the
layer body :func:`moe_dispatch` (``moe_dispatch_pallas`` there), whose
loop of k combines and adds is :func:`combine_slots`, one launch on the
card.  Each op picks its implementation by the device of the tensors it is
given: a CUDA tensor launches the hand-written kernels of :mod:`.kernel`
(or raises), a CPU tensor takes the plain versions of :mod:`.ref`.

Gradients.  The layer body runs its dispatch and combine as the
``autograd.Function`` classes :class:`DispatchSlots` and :class:`CombineSlots`,
whose backward passes are the same kernels (or plain versions): each
(expert, slot) row of the buffer holds at most one (token, routing slot)
assignment, since the slot is the rank within the expert, so the dispatch's
gradient is the combine of the buffer's gradient with weights 1, and the
combine's gradient with respect to the buffer is the dispatch of ``dy``
scaled by each slot's weight.  Its gradient with respect to the weights is
:func:`combine_weight_grad`.  The routing (``expert_slots``) takes no
gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import kernel as _k
from . import ref as _ref

__all__ = ["dispatch", "combine", "combine_slots", "combine_weight_grad",
           "moe_dispatch", "expert_slots", "DispatchSlots", "CombineSlots"]


_NARROW_IDS = (torch.uint8, torch.int8, torch.int16)


def _ids(t: torch.Tensor) -> torch.Tensor:
    """Routing ids as the kernels read them: int32 and int64 as they come,
    the narrower integer dtypes converted to int32 (a launch only then);
    any other dtype is left for the kernel's check to refuse."""
    return t.to(torch.int32) if t.dtype in _NARROW_IDS else t


def _weights(t: torch.Tensor) -> torch.Tensor:
    """Routing weights in float32; ``.to()`` alone costs host time, so it
    is called only when they are not."""
    return t if t.dtype == torch.float32 else t.float()


def dispatch(x: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
             num_experts: int, capacity: int,
             into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``[T, d]``; eidx/slot ``[T]`` (one routing slot, int8, uint8,
    int16, int32 or int64, any stride) → buf ``[E, C, d]``; with ``into``,
    ``into + buf`` written into ``into`` (on the card in the dispatch
    kernel itself)."""
    eidx, slot = _ids(eidx), _ids(slot)
    if x.device.type == "cuda":
        return _k.moe_dispatch(x.contiguous(), eidx, slot, num_experts,
                               capacity, into)
    buf = _ref.dispatch_ref(x, eidx, slot, num_experts, capacity)
    return buf if into is None else into.add_(buf)


def combine(buf: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]``; eidx/slot ``[T]`` (int8, uint8, int16, int32 or
    int64, any stride), w ``[T]`` → y ``[T, d]``."""
    eidx, slot, w = _ids(eidx), _ids(slot), _weights(w)
    if buf.device.type == "cuda":
        return _k.moe_combine(buf.contiguous(), eidx, slot, w)
    return _ref.combine_ref(buf, eidx, slot, w)


def combine_slots(buf: torch.Tensor, topk_idx: torch.Tensor,
                  slot: torch.Tensor, topk_w: torch.Tensor) -> torch.Tensor:
    """buf ``[E, C, d]``; topk_idx/slot/topk_w ``[T, k]`` (the routing as
    the layer has it; ids int8, uint8, int16, int32 or int64; any strides)
    → y ``[T, d]``: the k slots' combines added in slot order, ``y = c if
    y is None else y + c``."""
    topk_idx, slot, topk_w = _ids(topk_idx), _ids(slot), _weights(topk_w)
    if buf.device.type == "cuda":
        return _k.moe_combine_slots(buf.contiguous(), topk_idx, slot, topk_w)
    return _ref.combine_slots_ref(buf, topk_idx, slot, topk_w)


def combine_weight_grad(dy: torch.Tensor, buf: torch.Tensor,
                        topk_idx: torch.Tensor,
                        slot: torch.Tensor) -> torch.Tensor:
    """dy ``[T, d]``; buf ``[E, C, d]``; topk_idx/slot ``[T, k]`` → dw
    ``[T, k]`` float32: the combine's gradient with respect to each routing
    weight, ``Σ_d dy[t, d] · buf[e_tj, s_tj, d]`` (+0.0 when dropped)."""
    topk_idx, slot = _ids(topk_idx), _ids(slot)
    if buf.device.type == "cuda":
        return _k.moe_combine_weight_grad(dy.contiguous(), buf.contiguous(),
                                          topk_idx, slot)
    return _ref.combine_weight_grad_ref(dy, buf, topk_idx, slot)


class DispatchSlots(torch.autograd.Function):
    """x ``[T, d]`` → buf ``[E, C, d]`` over all k routing slots (slot j >
    0 added into the running buffer); backward dx = the combine of dbuf
    with weights 1 (+0.0 for a dropped assignment)."""

    @staticmethod
    def forward(ctx, x, topk_idx, slot, num_experts, capacity):
        buf = None
        for j in range(topk_idx.shape[1]):
            buf = dispatch(x, topk_idx[:, j], slot[:, j], num_experts,
                           capacity, buf)
        ctx.save_for_backward(topk_idx, slot)
        return buf

    @staticmethod
    def backward(ctx, dbuf):
        topk_idx, slot = ctx.saved_tensors
        ones = torch.ones(topk_idx.shape, dtype=torch.float32,
                          device=dbuf.device)
        dx = combine_slots(dbuf.contiguous(), topk_idx, slot, ones)
        return dx, None, None, None, None


class CombineSlots(torch.autograd.Function):
    """(buf ``[E, C, d]``, topk_w ``[T, k]``) → y ``[T, d]``
    (:func:`combine_slots`); backward dbuf = the dispatch of ``dy ·
    w_j`` over the k slots, dtopk_w = :func:`combine_weight_grad`."""

    @staticmethod
    def forward(ctx, buf, topk_idx, slot, topk_w):
        ctx.save_for_backward(buf, topk_idx, slot, topk_w)
        return combine_slots(buf, topk_idx, slot, topk_w)

    @staticmethod
    def backward(ctx, dy):
        buf, topk_idx, slot, topk_w = ctx.saved_tensors
        E, C, _ = buf.shape
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            w = topk_w.to(dy.dtype)
            for j in range(topk_idx.shape[1]):
                dbuf = dispatch(dy * w[:, j:j + 1], topk_idx[:, j],
                                slot[:, j], E, C, dbuf)
        if ctx.needs_input_grad[3]:
            dw = combine_weight_grad(dy, buf, topk_idx,
                                     slot).to(topk_w.dtype)
        return dbuf, None, None, dw


def expert_slots(topk_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each assignment's rank within its expert, over ALL k assignments
    in (token, k) order (the shared cumsum of the einsum and sort paths):
    ``[T, k]`` int32."""
    T, k = topk_idx.shape
    onehot_e = F.one_hot(topk_idx.reshape(-1).long(),
                         num_experts).to(torch.int32)
    pos = torch.cumsum(onehot_e, dim=0, dtype=torch.int32) - onehot_e
    return (pos * onehot_e).sum(dim=-1, dtype=torch.int32).reshape(T, k)


def moe_dispatch(params, x_flat: torch.Tensor, topk_idx: torch.Tensor,
                 topk_w: torch.Tensor, cfg, capacity: int,
                 expert_ffn: Callable) -> torch.Tensor:
    """The MoE layer body on the kernel path: k dispatch passes, the expert
    FFN, and the k slots' combine (one pass on the card), differentiable
    with respect to ``x_flat``, ``topk_w`` and the experts.  Same capacity
    and drop semantics as the model's einsum path."""
    slot = expert_slots(topk_idx, cfg.num_experts)
    buf = DispatchSlots.apply(x_flat, topk_idx, slot, cfg.num_experts,
                              capacity)
    out_buf = expert_ffn(params, buf, cfg)
    return CombineSlots.apply(out_buf, topk_idx, slot, topk_w)
