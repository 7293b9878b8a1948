"""Per-device counts of a torch program, and its roofline terms.

The counterpart of ``src/repro/roofline/analyze.py``, which walks XLA's
optimized, SPMD-partitioned HLO.  The port has no HLO: :class:`Counter` is
a ``TorchDispatchMode`` that sees every ATen op a program runs, DTensor
programs included, and counts what one device does.

* **Per device.**  An op on DTensors is left to DTensor (the mode returns
  ``NotImplemented``), which runs it as ops on each rank's local shards and
  collectives on them; the mode counts those.  So the counts are this
  rank's, where ``FlopCounterMode`` around DTensor code counts the logical,
  global figure.  DTensor's sharding propagation runs each new op once on
  fake tensors of the global shapes; their results are fake tensors, and
  the mode counts nothing for them.
* **flops**: ``torch.utils.flop_counter``'s formulas (matrix products,
  attention, convolutions: ``2·M·N·K`` a product) on the local shapes.
* **bytes**: operand plus result bytes of every op that moves data, at op
  granularity (the reference counts at fusion granularity, so an unfused
  elementwise chain counts more here); views, allocations and the
  functional collectives' waits and autograd wraps move none.
* **transcendentals**: result elements of the reference's five kinds
  (exp, tanh, log, rsqrt, pow), softmax's and logsumexp's exponentials
  among them.
* **collectives**: result bytes of each functional collective DTensor
  issues, by the reference's five kinds (no ``collective-permute`` exists
  in DTensor's redistributions), and ``collective_bytes`` their sum.
* **loops**: the port's depth loop is Python, so each layer is counted as
  it runs; there is no trip count to scale by.
* **live bytes**: each result's storage from its first op until it is
  freed (a weak reference to the storage), :attr:`Counter.peak_bytes` the
  largest sum; :meth:`Counter.hold` counts the arguments (parameters,
  optimizer state, batch) as live from the start.

:func:`roofline_terms` is the reference's arithmetic on the H100's rates
(:mod:`.hw`): ``compute = flops / PEAK_FLOPS_BF16``, ``memory = bytes /
HBM_BW``, ``collective = collective_bytes / NVLINK_BW``.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

__all__ = ["Counter", "count_program", "roofline_terms", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_TRANSCENDENTAL = {_aten.exp, _aten.exp2, _aten.expm1, _aten.tanh, _aten.log,
                   _aten.log1p, _aten.log2, _aten.rsqrt, _aten.pow,
                   _aten._softmax, _aten._log_softmax, _aten.logsumexp}
# ops that allocate or describe memory without moving data
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided, _aten.detach,
             _aten.alias, _aten.lift_fresh, _aten._local_scalar_dense,
             _aten.set_, _aten.resize_}
# functional collectives' bookkeeping: a wait, and the no-op wrap that
# lets autograd through an async result; neither moves data
_NO_BYTES_C10D = {"wait_tensor", "_wrap_tensor_autograd"}


def _collective_kind(func) -> str:
    """The reference's collective kind of a functional collective op, or
    ''."""
    if func.namespace != "_c10d_functional":
        return ""
    name = func._overloadpacket.__name__
    for kind, stem in (("all-reduce", "all_reduce"),
                       ("all-gather", "all_gather"),
                       ("reduce-scatter", "reduce_scatter"),
                       ("all-to-all", "all_to_all")):
        if name.startswith(stem):
            return kind
    return ""


def _tensors(tree):
    """The tensors of an op's arguments or results (a tensor, or lists,
    tuples and dicts of them, one level deep as ATen passes them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple, dict)):
            out += _tensors(a)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts one device's work while active (``with Counter() as c:``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collective_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.held_bytes = 0
        self._storages = WeakIdKeyDictionary()

    # -- live bytes ---------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = weakref.ref(st, lambda _, n=n: self._free(n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (DTensors by their local shards)
        as live; returns their bytes."""
        from ..distributed.sharding import is_dtensor
        from ..train.tree import tree_leaves

        before = self.live_bytes
        for t in (x for x in tree_leaves(tree)
                  if isinstance(x, torch.Tensor)):
            self._track(t.to_local() if is_dtensor(t) else t)
        self.held_bytes += self.live_bytes - before
        return self.live_bytes - before

    # -- counting -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # sharding propagation's shape inference
        packet = func._overloadpacket
        kind = _collective_kind(func)
        if kind:
            self.coll[kind] += sum(_nbytes(t) for t in outs)
            self.collective_ops += 1
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if packet in _TRANSCENDENTAL:
            src = args[0] if packet is _aten.logsumexp else out
            self.transcendentals += sum(t.numel() for t in _tensors(src))
        if not func.is_view and packet not in _NO_BYTES and not (
                func.namespace == "_c10d_functional"
                and packet.__name__ in _NO_BYTES_C10D):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        if not func.is_view:
            for t in outs:
                self._track(t)
        return out

    def result(self) -> Dict[str, float]:
        """The reference's ``analyze_hlo`` keys, per device."""
        r = {"flops": self.flops, "bytes": self.bytes,
             "transcendentals": self.transcendentals, **self.coll}
        r["collective_bytes"] = sum(self.coll.values())
        return r


def count_program(fn, *args, **kwargs) -> Dict[str, float]:
    """``fn(*args, **kwargs)`` run under a :class:`Counter`; its
    per-device counts."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.result()


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float) -> Dict[str, float]:
    """The reference's roofline terms on the H100's rates."""
    t_compute = flops_per_device / PEAK_FLOPS_BF16
    t_memory = bytes_per_device / HBM_BW
    t_coll = coll_bytes_per_device / NVLINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    total = max(t_compute, t_memory, t_coll)
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant, "bound_s": total,
            "roofline_fraction": t_compute / total if total > 0 else 0.0}
