"""The reference's parameter tree → the port's.

:func:`params_from_numpy` takes the reference model's params pytree with
numpy leaves (``jax.device_get(params)`` in the tests) and returns the
port's nested dict of tensors with the same keys and layouts, so that both
packages compute the same function.  Nothing here imports JAX: the tree
arrives as plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_numpy"]


def _leaf(arr, device: torch.device, dtype: Optional[torch.dtype]):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy kind
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """A nested dict (or list/tuple) of numpy arrays → the same structure
    of tensors on ``device`` (CUDA by default); ``dtype`` recasts the
    floating-point leaves."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _leaf(node, dev, dtype)

    return walk(tree)
