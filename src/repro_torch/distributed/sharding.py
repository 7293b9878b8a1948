"""Sharding rules: partition lanes and the LM's parameter, batch and cache
specs.  The counterpart of ``src/repro/distributed/sharding.py``.

**Partition lanes and their placement.**  The reference runs a sharded
fragment under ``shard_map`` over a 1-D mesh of the first ``num_parts``
devices (axis ``"part"``, :func:`relational_mesh`), one hash partition per
device; its tests and figures force eight host-platform devices on one
CPU.  The port keeps the reference's lanes (a constant, the reference's
forced mesh width: the broker's gang lease holds one logical lane per
partition) and places the partitions on the devices present in contiguous
blocks (:func:`partition_placement`): each device runs its block as the
rows of ``(block, bucket)`` tensors in one batched sequence of ops, and the
blocks' partials meet on the first device.  ``device="cuda"`` spreads over
every visible card (the reference takes ``jax.devices()``), a named card
or the CPU holds every partition, and a tuple of devices names the blocks'
devices outright (the CPU tests' analogue of the forced host devices).

**LM specs.**  2-D sharding on the ``("data", "model")`` mesh axes, with
the reference's rules: ``"model"`` carries tensor and expert parallelism
(head products, FFN hidden, the expert axis, vocab), ``"data"`` FSDP (the
non-TP dimension of every large matrix, gathered at use) and the batch,
``"pod"`` pure data parallelism across pods.  A spec is plain data, a
:class:`PartitionSpec` (one entry per dimension: ``None``, an axis name,
or a tuple of names), so the rules run on a mesh *shape* (axis names and
sizes) with no process group, as the tests and the dry-run planner do.
:func:`tree_shardings` turns specs into DTensor placements over a
``DeviceMesh`` and :func:`distribute_tree` lays a tree of tensors out by
them.  Rules are name-based over the leaf's path (``train.tree``'s paths,
which name the same leaves as ``jax.tree_util``'s), right-aligned to the
leaf's rank, so one table covers stacked (period) and unstacked (prefix)
layers.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Dict, Mapping, Tuple, Union

import torch

from ..train.tree import tree_paths, tree_unflatten

__all__ = [
    "PART_AXIS", "LOGICAL_LANES", "available_partitions", "check_partitions",
    "PartitionPlacement", "placement_devices", "partition_placement",
    "DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "PartitionSpec", "NamedSharding",
    "dp_axes", "dp_size", "dp_split", "mesh_axis_sizes", "param_specs", "batch_specs",
    "cache_specs", "spec_placements", "axis_placements", "tree_shardings",
    "distribute_tree", "is_dtensor",
]

#: the name of the partition axis (dim 0 of every partitioned column)
PART_AXIS = "part"

#: logical lanes a sharded fragment can fan out over, whatever the cards
LOGICAL_LANES = 8


def available_partitions() -> int:
    """Lanes a sharded fragment can fan out over: :data:`LOGICAL_LANES`."""
    return LOGICAL_LANES


def check_partitions(num_parts: int) -> int:
    """``num_parts`` as an int, or ``ValueError`` outside ``1 ..
    available_partitions()`` (the reference's ``relational_mesh`` check)."""
    num_parts = int(num_parts)
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    if num_parts > available_partitions():
        raise ValueError(
            f"num_parts={num_parts} exceeds the {available_partitions()} "
            f"logical partition lanes")
    return num_parts


@dataclasses.dataclass(frozen=True)
class PartitionPlacement:
    """Where a fragment's ``num_parts`` partitions live: group ``g`` holds
    partitions ``bounds[g]`` to ``bounds[g + 1] - 1`` on ``devices[g]``.
    The port's counterpart of :func:`partition_sharding`'s mesh; its
    :attr:`key` names it in the layout and program caches."""
    devices: Tuple[torch.device, ...]
    bounds: Tuple[int, ...]

    @property
    def num_parts(self) -> int:
        return self.bounds[-1]

    @property
    def groups(self) -> Tuple[Tuple[torch.device, int, int], ...]:
        """``(device, first partition, end)`` of each block, in order."""
        return tuple(zip(self.devices, self.bounds[:-1], self.bounds[1:]))

    @property
    def key(self) -> Tuple[Tuple[str, int, int], ...]:
        return tuple((str(d), lo, hi) for d, lo, hi in self.groups)


def placement_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices a sharded fragment spreads over: every visible card for
    ``"cuda"`` (or ``None``) without an index, the device alone for a named
    card, the CPU or another device, each device of a tuple in order.  A
    card that is not present raises; nothing falls back to fewer cards."""
    from ..device import resolve_device

    if isinstance(device, PartitionPlacement):
        return device.devices
    if isinstance(device, (tuple, list)):
        devs = tuple(resolve_device(d) for d in device)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            devs = tuple(torch.device("cuda", i)
                         for i in range(torch.cuda.device_count()))
        else:
            devs = (dev,)
    if not devs:
        raise ValueError("a placement needs at least one device")
    for d in devs:
        if d.type == "cuda" and not (d.index is None
                                     or d.index < torch.cuda.device_count()):
            raise RuntimeError(
                f"{d} is not present: {torch.cuda.device_count()} cards "
                f"are visible")
    return devs


def partition_placement(num_parts: int, device=None) -> PartitionPlacement:
    """``num_parts`` partitions over :func:`placement_devices` of
    ``device`` in contiguous blocks, the first ``num_parts % n`` of them
    one partition longer (8 on 4 devices: 2 each; 3 on 2: {0, 1}, {2});
    never more blocks than partitions.  A placement passes through."""
    if isinstance(device, PartitionPlacement):
        if device.num_parts != int(num_parts):
            raise ValueError(f"a placement of {device.num_parts} partitions "
                             f"asked for {num_parts}")
        return device
    num_parts = int(num_parts)
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    devs = placement_devices(device)[:num_parts]
    size, extra = divmod(num_parts, len(devs))
    bounds = [0]
    for g in range(len(devs)):
        bounds.append(bounds[-1] + size + (g < extra))
    return PartitionPlacement(devs, tuple(bounds))


# ---------------------------------------------------------------------------
# LM sharding rules
# ---------------------------------------------------------------------------

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"

#: a mesh, or its shape as ``{axis name: size}`` in mesh order
MeshLike = Union[Mapping[str, int], Any]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), an axis name,
    or a tuple of axis names (the dimension split over several mesh axes,
    the first the major one; a tuple of one name is that name, as JAX
    normalises it); missing trailing entries are ``None``.  The
    reference's ``jax.sharding.PartitionSpec`` as plain data."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a ``DeviceMesh``; :attr:`placements` are its DTensor
    placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return spec_placements(self.mesh, self.spec)


def mesh_axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh shape given
    as such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: MeshLike) -> Tuple[str, ...]:
    """Data-parallel axes: ``("pod", "data")`` when the mesh has a pod
    axis."""
    names = mesh_axis_sizes(mesh)
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)


def dp_size(mesh: MeshLike) -> int:
    """The product of the data-parallel axes' sizes."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(sizes))


def dp_split(mesh: MeshLike, n: int) -> Tuple[str, ...]:
    """The data-parallel axes a dimension of ``n`` splits over: all of
    them where ``n`` divides their size, none otherwise."""
    size = dp_size(mesh)
    return dp_axes(mesh) if n % size == 0 and n >= size else ()


# name → trailing-dims spec (right-aligned; missing leading dims → None).
# The embedding shards its EMBED dim and replicates vocab: a gather over a
# vocab-sharded table replicates its [B, S, d] output, while d-sharding
# keeps the lookup local.
_TRAILING_RULES = {
    "table": (None, "model"),
    "lm_head": ("data", "model"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wi": ("data", "model"),
    "wg": ("data", "model"),
    "wo": ("model", "data"),
    "w_uk": ("data", "model"),
    "w_uv": ("data", "model"),
    "w_dkv": ("data", None),
    "router": ("data", None),
    "wz": ("data", "model"),
    "wx": ("data", "model"),
    "wb": ("data", None),
    "wc": ("data", None),
    "wdt": ("data", None),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "proj": ("data", "model"),
}

# expert-stacked leaves (leading E axis → expert parallelism on "model")
_EXPERT_RULES = {
    "wg": ("model", "data", None),
    "wi": ("model", "data", None),
    "wo": ("model", None, "data"),
}


def _spec_for(names: Tuple[str, ...], shape: Tuple[int, ...],
              num_experts: int) -> PartitionSpec:
    if not names:
        return PartitionSpec()
    name = names[-1]
    nd = len(shape)
    is_expert = (name in _EXPERT_RULES and "shared" not in names
                 and nd >= 3 and num_experts > 0
                 and shape[-3] == num_experts)
    rule = _EXPERT_RULES[name] if is_expert else _TRAILING_RULES.get(name)
    if rule is None or nd < len(rule):
        return PartitionSpec()  # small or unknown leaves: replicated
    return PartitionSpec(*([None] * (nd - len(rule)) + list(rule)))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _specs(tree, rule):
    """A tree of ``tree``'s structure holding ``rule(path, shape)`` for
    each leaf."""
    return tree_unflatten(tree, [rule(path, _shape(leaf))
                                 for path, leaf in tree_paths(tree)])


def param_specs(params: Any, cfg, *, fsdp: bool = True) -> Any:
    """A :class:`PartitionSpec` tree matching a parameter tree (or an
    optimizer state, whose leaves are named by the parameter they follow).

    ``fsdp=False`` drops the ``"data"`` (FSDP) axis from every rule: pure
    tensor parallelism."""
    def rule(path, shape):
        spec = _spec_for(path, shape, cfg.num_experts)
        if not fsdp:
            spec = PartitionSpec(*[None if e == DATA_AXIS else e
                                   for e in spec])
        return spec
    return _specs(params, rule)


def batch_specs(batch: Any, mesh: MeshLike) -> Any:
    """The batch dimension over the data-parallel axes (replicated if the
    batch does not divide them); ``positions`` ``[3, B, S]`` has it second."""
    def rule(path, shape):
        batch_axis = 1 if path and path[-1] == "positions" else 0
        dp = dp_split(mesh, shape[batch_axis])
        if not dp:
            return PartitionSpec()
        spec = [None] * len(shape)
        spec[batch_axis] = dp
        return PartitionSpec(*spec)
    return _specs(batch, rule)


def cache_specs(cache: Any, cfg, mesh: MeshLike) -> Any:
    """Decode-cache specs.  Attention K/V: batch over the data-parallel
    axes, the SEQUENCE over ``"model"`` (context-parallel decode: scores
    stay local and only the softmax statistics and the ``(B, H, D)`` output
    are reduced); MLA's compressed cache the same; the conv tail its
    channels and the SSD state its heads over ``"model"``.  ``pos``
    replicates."""
    model_size = mesh_axis_sizes(mesh)[MODEL_AXIS]

    def rule(path, shape):
        name = path[-1]
        if name == "pos" or not shape:
            return PartitionSpec()
        # a leading period axis iff under "blocks"
        lead = [None] if path[0] == "blocks" else []
        batch = dp_split(mesh, shape[len(lead)]) or None

        def fits(dim):
            d = shape[len(lead) + dim]
            return d % model_size == 0 and d >= model_size

        if name in ("k", "v"):
            seq = MODEL_AXIS if fits(1) else None
            return PartitionSpec(*lead, batch, seq, None, None)
        if name == "ckv":
            return PartitionSpec(*lead, batch,
                                 MODEL_AXIS if fits(1) else None, None)
        if name == "conv":
            return PartitionSpec(*lead, batch, None,
                                 MODEL_AXIS if fits(2) else None)
        if name == "ssd":
            return PartitionSpec(*lead, batch,
                                 MODEL_AXIS if fits(1) else None, None, None)
        return PartitionSpec()
    return _specs(cache, rule)


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` over ``mesh``: ``Shard(dim)`` on
    the mesh dimension each axis names, ``Replicate()`` elsewhere.  A tuple
    of axes shards one tensor dimension over several mesh dimensions, which
    must come in mesh order (DTensor splits a dimension over its mesh
    dimensions left to right, the tuple's major axis first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dimension {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards "
                                 f"two dimensions")
            placements[i] = Shard(dim)
    return tuple(placements)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; none exists before
    ``torch.distributed.tensor`` is imported, so a path that never meets
    one does not pay for the import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def axis_placements(mesh, shard: Mapping[str, int] = None,
                    partial: Tuple[str, ...] = ()) -> tuple:
    """Placements over ``mesh`` by axis name: ``Shard(dim)`` on each axis
    ``shard`` maps to a tensor dimension, ``Partial()`` (a sum) on each
    axis of ``partial``, ``Replicate()`` elsewhere; names the mesh lacks
    are ignored.  The local layouts of the hand kernels' calls on a mesh
    are written this way."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    shard = shard or {}
    return tuple(Shard(shard[a]) if a in shard
                 else Partial() if a in partial else Replicate()
                 for a in mesh.mesh_dim_names)


def _spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree, whose leaves are
    :class:`PartitionSpec` (a tuple the walk does not enter), and the
    matching leaves of ``trees``."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return type(specs)(_spec_map(fn, s, *(t[i] for t in trees))
                       for i, s in enumerate(specs))


def tree_shardings(mesh, specs: Any) -> Any:
    """A :class:`NamedSharding` per spec of ``specs`` over ``mesh``."""
    return _spec_map(lambda s: NamedSharding(mesh, s), specs)


def distribute_tree(tree: Any, mesh, specs: Any) -> Any:
    """``tree``'s tensors laid out over ``mesh`` by ``specs`` as DTensors
    (``distribute_tensor``: every rank holds the full tensor and keeps its
    shard); a leaf that is not a tensor (a cache's ``pos``) stays as it is.
    ``requires_grad`` carries over, and a leaf that had it is a leaf of
    the autograd graph again."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def place(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = distribute_tensor(leaf.detach(), mesh,
                                spec_placements(mesh, spec))
        return out.requires_grad_(leaf.requires_grad)
    return _spec_map(place, specs, tree)
