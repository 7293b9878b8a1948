"""Shape-only stand-ins for every model input and state tree.  The
counterpart of ``src/repro/launch/specs.py``.

The reference builds ``ShapeDtypeStruct`` trees with ``jax.eval_shape``;
the port builds its real trees on ``torch.device("meta")``, which holds
shapes and dtypes and allocates no storage, so a 398 B configuration's
parameters and optimizer state are planned on a laptop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeSpec
from ..models import init_cache, init_model
from ..train.optimizer import Optimizer

__all__ = ["input_specs", "sharded_config", "abstract_params",
           "abstract_opt_state", "abstract_cache", "META"]

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """The batch of one (arch, shape) cell as meta tensors."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.modality == "audio_stub":
        batch["features"] = torch.empty((B, S, cfg.d_model),
                                        dtype=torch.bfloat16, device=META)
    else:
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    if cfg.mrope_sections:
        batch["positions"] = torch.empty((3, B, S), dtype=torch.int32,
                                         device=META)
    if with_labels:
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return batch


def sharded_config(cfg: ArchConfig) -> ArchConfig:
    """Production variant: vocab padded to 256 (the lcm of both mesh
    axes)."""
    return dataclasses.replace(cfg, vocab_pad_multiple=256)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """``init_model``'s tree on the meta device."""
    return init_model(torch.Generator().manual_seed(0), cfg, dtype,
                      device=META)


def abstract_opt_state(optimizer: Optimizer, params):
    """``optimizer.init``'s state for meta parameters, on the meta
    device."""
    return optimizer.init(params)


def abstract_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
                   dtype=torch.bfloat16):
    """``init_cache``'s tree on the meta device."""
    return init_cache(cfg, batch_size, max_seq, dtype, device=META)
