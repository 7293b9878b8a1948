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

On a mesh.  DTensor inputs never reach a kernel's extension call: they run
through ``local_map``, each rank's call the ordinary one on its shards.
The layer body :func:`moe_dispatch` takes the reference's layout (tokens
split over the data-parallel axes, experts over ``"model"``; see
``_sharded_layer``): its local calls are the slot ``autograd.Function``s
as on one device, the kernels on CUDA shards and elsewhere (the CPU, and
the meta device a dry-run plans on) plain versions whose shapes do not
depend on the data.  Another rank's expert ids fall outside
``[0, E_local)`` and are dropped.
The single ops take every input replicated.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ...distributed.sharding import (axis_placements, dp_split, is_dtensor,
                                     mesh_axis_sizes)
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


def _replicated(fn, *args):
    """``fn(*args)`` for DTensor ``args`` through ``local_map``, every
    tensor replicated over the mesh (its gradient too)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    rep = axis_placements(mesh)
    pl = tuple(rep if isinstance(a, torch.Tensor) else None for a in args)
    return local_map(fn, out_placements=(rep,), in_placements=pl,
                     in_grad_placements=pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def dispatch(x: torch.Tensor, eidx: torch.Tensor, slot: torch.Tensor,
             num_experts: int, capacity: int,
             into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``[T, d]``; eidx/slot ``[T]`` (one routing slot, int8, uint8,
    int16, int32 or int64, any stride) → buf ``[E, C, d]``; with ``into``,
    ``into + buf`` written into ``into`` (on the card in the dispatch
    kernel itself)."""
    if is_dtensor(x):
        return _replicated(lambda *a: dispatch(*a[:3], num_experts,
                                               capacity, a[3]),
                           x, eidx, slot, into)
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
    if is_dtensor(buf):
        return _replicated(combine, buf, eidx, slot, w)
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
    if is_dtensor(buf):
        return _replicated(combine_slots, buf, topk_idx, slot, topk_w)
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
    if is_dtensor(buf):
        return _replicated(combine_weight_grad, dy, buf, topk_idx, slot)
    topk_idx, slot = _ids(topk_idx), _ids(slot)
    if buf.device.type == "cuda":
        return _k.moe_combine_weight_grad(dy.contiguous(), buf.contiguous(),
                                          topk_idx, slot)
    return _ref.combine_weight_grad_ref(dy, buf, topk_idx, slot)


def _dispatch_slots(x, topk_idx, slot, num_experts, capacity, w=None):
    """All k routing slots' dispatch (of ``x · w[:, j]`` where w is given):
    on the card one kernel launch a slot, each added into the running
    buffer; elsewhere :func:`.ref.dispatch_slots_ref`."""
    if x.device.type != "cuda":
        return _ref.dispatch_slots_ref(x, topk_idx, slot, num_experts,
                                       capacity, w)
    buf = None
    for j in range(topk_idx.shape[1]):
        buf = dispatch(x if w is None else x * w[:, j:j + 1],
                       topk_idx[:, j], slot[:, j], num_experts, capacity, buf)
    return buf


class DispatchSlots(torch.autograd.Function):
    """x ``[T, d]`` → buf ``[E, C, d]`` over all k routing slots (slot j >
    0 added into the running buffer); backward dx = the combine of dbuf
    with weights 1 (+0.0 for a dropped assignment)."""

    @staticmethod
    def forward(ctx, x, topk_idx, slot, num_experts, capacity):
        ctx.save_for_backward(topk_idx, slot)
        return _dispatch_slots(x, topk_idx, slot, num_experts, capacity)

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
            dbuf = _dispatch_slots(dy, topk_idx, slot, E, C,
                                   topk_w.to(dy.dtype))
        if ctx.needs_input_grad[3]:
            dw = combine_weight_grad(dy, buf, topk_idx,
                                     slot).to(topk_w.dtype)
        return dbuf, None, None, dw


def expert_slots(topk_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each assignment's rank within its expert, over ALL k assignments
    in (token, k) order (the shared cumsum of the einsum and sort paths):
    ``[T, k]`` int32."""
    if is_dtensor(topk_idx):
        return _replicated(lambda t: expert_slots(t, num_experts), topk_idx)
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
    if is_dtensor(x_flat):
        return _sharded_layer(params, x_flat, topk_idx, topk_w, cfg,
                              capacity, expert_ffn)
    slot = expert_slots(topk_idx, cfg.num_experts)
    return _layer(params, x_flat, topk_idx, slot, topk_w, cfg.num_experts,
                  capacity, expert_ffn, cfg)


def _layer(params, x_flat, eidx, slot, topk_w, num_experts, capacity,
           expert_ffn, cfg):
    buf = DispatchSlots.apply(x_flat, eidx, slot, num_experts, capacity)
    out_buf = expert_ffn(params, buf, cfg)
    return CombineSlots.apply(out_buf, eidx, slot, topk_w)


def _sharded_layer(params, x_flat, topk_idx, topk_w, cfg, capacity,
                   expert_ffn):
    """The layer body over DTensors, in the reference's layout: tokens and
    routing split over the data-parallel axes (replicated across
    ``"model"``), experts over ``"model"``.  Each rank dispatches its tokens
    into its experts' rows through ``local_map`` (a partial sum over the
    data-parallel axes: each row holds one assignment), which one
    reduce-scatter lays out for the expert FFN with the capacity rows
    split over ``"data"``; each rank runs its share of its experts' rows,
    and combines its tokens from its experts' rows, gathered whole (a
    partial sum over ``"model"``).  The slots are every assignment's rank
    within its expert over the WHOLE routing."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x_flat.device_mesh
    sizes = mesh_axis_sizes(mesh)
    E = cfg.num_experts
    m = sizes.get("model", 1)
    split = m > 1 and E % m == 0
    E_l = E // m if split else E
    lo = mesh.get_local_rank("model") * E_l if split else 0
    rows = {a: 0 for a in dp_split(mesh, x_flat.shape[0])}
    experts = {"model": 0} if split else {}
    model_sum = ("model",) if split else ()
    tok = axis_placements(mesh, rows)
    tok_grad = axis_placements(mesh, rows, model_sum)   # own experts' share
    exp = axis_placements(mesh, experts)
    exp_part = axis_placements(mesh, experts, tuple(rows))  # own tokens'
    slot = expert_slots(topk_idx, E)                    # replicated

    def local_dispatch(x, idx, s):
        e = idx - lo if lo else idx   # another rank's experts: dropped
        return DispatchSlots.apply(x, e, s, E_l, capacity)

    def local_combine(b, idx, s, w):
        return CombineSlots.apply(b, idx - lo if lo else idx, s, w)

    buf = local_map(local_dispatch, out_placements=(exp_part,),
                    in_placements=(tok, tok, tok),
                    in_grad_placements=(tok_grad, tok, tok),
                    device_mesh=mesh, redistribute_inputs=True)(
        x_flat, topk_idx, slot)
    # the expert FFN's rows: capacity split over "data" where it divides,
    # as the reference lays the buffer out ("model", "data", None), so a
    # data rank runs its share of its experts' rows, not all of them
    data = sizes.get("data", 1)
    ffn_rows = dict(experts, **({"data": 1} if data > 1
                                and capacity % data == 0 else {}))
    out_buf = expert_ffn(params, buf.redistribute(
        mesh, axis_placements(mesh, ffn_rows)), cfg)
    return local_map(local_combine,
                     out_placements=(axis_placements(mesh, rows, model_sum),),
                     in_placements=(exp, tok, tok, tok),
                     in_grad_placements=(exp_part, tok, tok, tok_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        out_buf, topk_idx, slot, topk_w)
