"""The reference's parameter tree → the port's, and back.

:func:`params_from_numpy` takes the reference model's params pytree with
numpy leaves (``jax.device_get(params)`` in the tests) and returns the
port's nested dict of tensors with the same keys and layouts, so that both
packages compute the same function.  :func:`params_to_numpy` is its
inverse: the port's tree with numpy leaves, for checkpoints and tests.
Nothing here imports JAX: the tree arrives as plain dicts of numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


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


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: a nested dict (or
    list/tuple) of tensors → the same structure of numpy arrays on the
    host, bfloat16 as float32 (numpy has no bfloat16); anything that is
    not a tensor is left as it is."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return tree
