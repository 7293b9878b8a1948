"""Sharding constraints usable from plain model code.

The counterpart of ``src/repro/models/pspec.py``.  ``constrain(x, "dp",
None, "model")`` lays a DTensor out over the *ambient* mesh, the
``DeviceMesh`` of the enclosing ``with mesh:`` scope, by the reference's
logical names:

  "dp"    → the data-parallel axes present in the mesh (``("pod",
            "data")`` or ``("data",)``),
  "model" → the tensor-parallel axis,
  None    → replicated.

The gradient is held to the same layout, as JAX lays out the cotangent of
a constraint.  Outside a mesh scope, or on a plain tensor, it returns
``x`` itself, so model code stays mesh-agnostic and an unsharded run
computes exactly what it did without it.  A dimension that does not
divide its axis is left replicated, as the reference leaves it to the
solver.  A sharded step runs inside :func:`mesh_scope`.
"""
from __future__ import annotations

import contextlib
import math

from ..distributed.sharding import (MODEL_AXIS, PartitionSpec, dp_axes,
                                    is_dtensor, spec_placements)

__all__ = ["ambient_mesh", "mesh_scope", "axis_size", "constrain", "constrain_kv_cache",
           "with_sharding_constraint"]


def ambient_mesh():
    """The ``DeviceMesh`` of the innermost ``with mesh:`` scope, or None."""
    from torch.distributed.device_mesh import _mesh_resources

    return _mesh_resources.get_current_mesh() \
        if _mesh_resources.mesh_stack else None


@contextlib.contextmanager
def mesh_scope(mesh):
    """The scope a sharded step runs in: ``mesh`` ambient (``with mesh:``,
    which :func:`constrain` reads) and the plain tensors the step makes
    (rope tables, masks, running sums) taken as replicated DTensors
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with mesh, implicit_replication():
        yield mesh


def axis_size(name) -> int:
    """The ambient mesh's size for a logical name (1 without a mesh)."""
    mesh = ambient_mesh()
    e = _resolve(name, mesh) if mesh is not None else None
    return 1 if e is None else _axis_size(e, mesh)


def _resolve(name, mesh):
    if name is None:
        return None
    if name == "dp":
        return dp_axes(mesh) or None
    return name if name in mesh.mesh_dim_names else None


def _axis_size(entry, mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[a] for a in axes)


def with_sharding_constraint(x, sharding):
    """``x`` redistributed to ``sharding`` (a
    :class:`~repro_torch.distributed.sharding.NamedSharding`) when it is a
    DTensor; ``x`` itself otherwise."""
    if sharding is None or not is_dtensor(x):
        return x
    return _pin(x, sharding.mesh, sharding.placements)


def constrain(x, *names):
    """``x`` laid out by the logical ``names`` (one a dimension) over the
    ambient mesh; ``x`` itself outside a mesh or for a plain tensor."""
    if not is_dtensor(x):
        return x
    mesh = ambient_mesh()
    if mesh is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"constrain: {len(names)} names for a tensor of "
                         f"shape {tuple(x.shape)}")
    entries = []
    for dim, name in zip(x.shape, names):
        e = _resolve(name, mesh)
        if e is not None and dim % _axis_size(e, mesh) != 0:
            e = None  # does not divide: left replicated
        entries.append(e)
    return _pin(x, mesh, spec_placements(mesh, PartitionSpec(*entries)))


def _pin(x, mesh, placements):
    """``x`` in ``placements``, and its gradient too, as the transpose of
    ``with_sharding_constraint`` lays the cotangent out: a gradient that
    autograd would hand back in another split (one a reshape behind it
    cannot take) is redistributed on its way through."""
    from torch.distributed.tensor import DTensor

    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return DTensor.from_local(x.to_local(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def constrain_kv_cache(x):
    """A ``[B, S, ...]`` cache, context-parallel: the SEQUENCE over
    ``"model"`` when it divides (as ``distributed.sharding.cache_specs``
    lays the cache out, so the decode write never re-lays it out), the
    batch over the data-parallel axes."""
    if not is_dtensor(x):
        return x
    mesh = ambient_mesh()
    if mesh is None:
        return x
    names = mesh.mesh_dim_names
    model = mesh.shape[names.index(MODEL_AXIS)] if MODEL_AXIS in names else 1
    S = x.shape[1]
    if S % model == 0 and S >= model:
        return constrain(x, "dp", "model", *([None] * (x.ndim - 2)))
    return constrain(x, "dp", *([None] * (x.ndim - 1)))
