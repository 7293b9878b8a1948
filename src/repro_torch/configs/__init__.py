"""Assigned-architecture configuration registry."""
from .base import ArchConfig, get_config, get_smoke_config, list_archs
from .shapes import SHAPES, ShapeSpec, all_cells, applicable

__all__ = [
    "ArchConfig", "SHAPES", "ShapeSpec", "all_cells", "applicable",
    "get_config", "get_smoke_config", "list_archs",
]
