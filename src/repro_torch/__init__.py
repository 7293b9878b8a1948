"""PyTorch/CUDA port of the relational engine (``src/repro`` is the JAX
reference it is held against).

``repro_torch.core`` is the engine: :class:`~repro_torch.core.Session` →
planner → :class:`~repro_torch.core.Executor` → path selector → the fused
device fragment or the per-operator device operators, on a CUDA device by
default.  ``repro_torch.kernels`` holds the hand-written Hopper kernels with
their plain PyTorch versions, and :mod:`repro_torch.device` the device
helpers, the kernel build and the per-kernel launch counters.  Nothing
here imports JAX or the reference package.
"""
