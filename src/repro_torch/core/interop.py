"""State carried across from the reference engine, as plain data.

The reference (``src/repro``) and this package keep separate classes, and
this package imports nothing of the reference.  What crosses between them is
plain data — numpy arrays and dicts — which is how the parity tests hand
both engines the same tables and the same cost constants, so that both make
the same path decisions on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

from .cost_model import CostConstants
from .relation import Relation

__all__ = ["tables_from_numpy", "cost_constants_from_dict"]


def tables_from_numpy(tables: Mapping[str, Mapping[str, np.ndarray]]
                      ) -> Dict[str, Relation]:
    """``{name: {column: ndarray}}`` → ``{name: Relation}`` of this package.

    The columns are taken as they are (same dtypes, same values); the
    relations' device caches start empty."""
    return {name: Relation({c: np.asarray(v) for c, v in cols.items()})
            for name, cols in tables.items()}


def cost_constants_from_dict(values: Mapping[str, object]) -> CostConstants:
    """``dataclasses.asdict(reference_constants)`` → :class:`CostConstants`.

    Every field must be a field of this package's constants: a name the port
    does not know is a drift between the two cost models and raises."""
    known = {f.name for f in dataclasses.fields(CostConstants)}
    unknown = sorted(set(values) - known)
    if unknown:
        raise KeyError(f"cost constants unknown to the port: {unknown}")
    return CostConstants(**dict(values))
