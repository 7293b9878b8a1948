"""Device meshes.  The counterpart of ``src/repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh spans the ranks of the process group the caller
initialised (``torch.distributed.init_process_group``): NCCL over cards,
gloo over CPU processes, or, for a dry-run that plans a mesh larger than
the machine, the fake group of ``torch.testing._internal.distributed.
fake_pg`` (one process standing for every rank; ``launch/dryrun.py`` starts
it).
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_local_mesh", "PRODUCTION_SHAPES"]

#: the reference's production meshes: one pod, and two pods
PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
    ``"pod"``, over a process group of 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    n = math.prod(shape)
    have = _world_size()
    if have != n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, found "
            f"{have}: for a dry-run start the fake group first, "
            f"torch.distributed.init_process_group('fake', store=FakeStore(),"
            f" rank=0, world_size={n}) with FakeStore from "
            f"torch.testing._internal.distributed.fake_pg "
            f"(launch/dryrun.py does this)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over the initialised process group, whose
    size must be ``data · model`` (tests and one-card runs)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = data * model
    have = _world_size()
    if have != n:
        raise RuntimeError(f"a ({data}, {model}) mesh needs a process group "
                           f"of {n} ranks, found {have}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
