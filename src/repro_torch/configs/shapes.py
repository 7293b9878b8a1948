"""Assigned input shapes and the (arch × shape) applicability matrix."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "applicable", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Returns (runs?, reason-if-skipped). Skips are per DESIGN.md §5."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; this arch "
                       "has full-attention layers throughout")
    return True, ""


def all_cells():
    """Every runnable (arch, shape) cell, plus the skip list."""
    from .base import get_config, list_archs
    cells, skips = [], []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = applicable(cfg, shape)
            (cells if ok else skips).append((arch, shape.name, why))
    return cells, skips
