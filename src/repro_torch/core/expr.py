"""Typed expression language for declarative predicates and projections.

The seed front-end took opaque Python lambdas as filter predicates, which the
engine could not introspect: pushdown was impossible, projection pruning was
impossible, and compiled-program caching had to fall back to fragile bytecode
hashing (``fused._predicate_key``).  An :class:`Expr` tree is the declarative
replacement — a tiny algebra over columns:

    >>> from repro_torch.core.expr import col
    >>> pred = (col("w") > 0) & ~col("flag").isin([2, 3])

An expression simultaneously supports every execution regime the engine has:

  * **linear / host** — calling ``pred(relation)`` evaluates with numpy and
    returns a row mask (the relational WHERE contract);
  * **fused / device** — the same call evaluates on torch tensors inside the
    fused device program (``isin`` dispatches on the operand type, and
    arithmetic keeps the reference's 64-bit promotion rules);
  * **planning** — :meth:`Expr.columns` names exactly the columns the
    predicate reads (filter pushdown, projection pruning) and
    :meth:`Expr.cache_token` is a canonical value-identity for compiled-
    program caching: two independently *rebuilt* but structurally equal
    expressions share one compiled program, and any change of structure,
    column, constant value, or constant *type* is a different token.

Expressions are immutable; operators build new nodes.  ``&``/``|``/``~`` are
the boolean connectives (Python's ``and``/``or`` cannot be overloaded).
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Dict, FrozenSet, Tuple

import numpy as np
import torch

__all__ = ["Expr", "Col", "Lit", "BinOp", "Not", "IsIn", "CombinedPredicate",
           "col", "lit"]


_BIN_OPS: Dict[str, Callable] = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "//": operator.floordiv,
    "%": operator.mod,
    ">": operator.gt,
    ">=": operator.ge,
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
    "&": operator.and_,
    "|": operator.or_,
}

# Literal types whose VALUES are canonical cache-key material.  Type-tagged
# in tokens because Python equates across them (1 == 1.0 == True) while the
# traced program bakes the dtype in.
_LIT_TYPES = (bool, int, float)


def _torch_operands(op: str, a, b):
    """Operands of a binary operator on torch tensors, promoted the way the
    reference promotes them under 64-bit JAX: a Python float meets an
    integer tensor as float64 (torch would make it float32), and true
    division of integers is float64."""
    ref = a if isinstance(a, torch.Tensor) else b

    def lift(v):
        if isinstance(v, float):
            return torch.tensor(v, dtype=torch.float64, device=ref.device)
        return v

    a, b = lift(a), lift(b)
    if op == "/":
        def f64(v):
            if isinstance(v, torch.Tensor):
                if not v.dtype.is_floating_point:
                    return v.to(torch.float64)
                return v
            return float(v)
        a, b = f64(a), f64(b)
    return a, b


def _coerce(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, _LIT_TYPES):
        return Lit(v)
    if isinstance(v, (np.bool_, np.integer, np.floating)):
        return Lit(v.item())
    raise TypeError(
        f"cannot use {type(v).__name__} in an expression; expected an Expr "
        f"or a bool/int/float literal")


class Expr:
    """Base expression node.  Calling an expression evaluates it against a
    column view — anything supporting ``view[name] -> array`` (a host
    ``Relation``, a ``DeviceRelation``, the fused pipeline's ``_JoinView``,
    or a plain dict of arrays)."""

    # -- evaluation --------------------------------------------------------
    def __call__(self, view):
        raise NotImplementedError

    # -- planning introspection -------------------------------------------
    def columns(self) -> FrozenSet[str]:
        """Names of every column this expression reads."""
        raise NotImplementedError

    def cache_token(self) -> Tuple:
        """Canonical, hashable value-identity of this expression.

        Stable across rebuilt-but-equal trees; distinct whenever structure,
        a column name, a constant value, or a constant type differs.
        """
        raise NotImplementedError

    def rename_columns(self, mapping: Dict[str, str]) -> "Expr":
        """A copy with column references renamed (planner pushdown uses this
        to translate join-output names like ``b_v`` to child names)."""
        raise NotImplementedError

    # -- operator algebra --------------------------------------------------
    def _bin(self, op: str, other, reflected: bool = False) -> "BinOp":
        other = _coerce(other)
        return BinOp(op, other, self) if reflected else BinOp(op, self, other)

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, True)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, True)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, True)
    def __truediv__(self, o): return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, True)
    def __floordiv__(self, o): return self._bin("//", o)
    def __rfloordiv__(self, o): return self._bin("//", o, True)
    def __mod__(self, o): return self._bin("%", o)
    def __rmod__(self, o): return self._bin("%", o, True)
    def __gt__(self, o): return self._bin(">", o)
    def __ge__(self, o): return self._bin(">=", o)
    def __lt__(self, o): return self._bin("<", o)
    def __le__(self, o): return self._bin("<=", o)
    def __eq__(self, o): return self._bin("==", o)  # noqa: D105
    def __ne__(self, o): return self._bin("!=", o)
    def __and__(self, o): return self._bin("&", o)
    def __rand__(self, o): return self._bin("&", o, True)
    def __or__(self, o): return self._bin("|", o)
    def __ror__(self, o): return self._bin("|", o, True)
    def __invert__(self): return Not(self)

    # __eq__ is an expression builder, so identity hashing keeps Expr usable
    # in sets/dicts; cache keys use cache_token(), never hash(expr)
    __hash__ = object.__hash__

    def __bool__(self):
        # Python rewrites `0 < col < 10` as `(0 < col) and (col < 10)` and
        # `and`/`or` truth-test their left operand — which would silently
        # DROP that operand from the predicate.  Refuse, like pandas/polars.
        raise TypeError(
            "the truth value of an Expr is ambiguous: use `&`/`|`/`~` "
            "instead of `and`/`or`/`not`, and split chained comparisons "
            "(`a < col(...) < b` → `(col(...) > a) & (col(...) < b)`)")

    def isin(self, values) -> "IsIn":
        """Membership test against a fixed set of scalar values."""
        vals = []
        for v in values:
            if isinstance(v, (np.bool_, np.integer, np.floating)):
                v = v.item()
            if not isinstance(v, _LIT_TYPES):
                raise TypeError(f"isin values must be bool/int/float, "
                                f"got {type(v).__name__}")
            vals.append(v)
        return IsIn(self, tuple(vals))

    def conjuncts(self) -> Tuple["Expr", ...]:
        """Split a top-level AND chain into its factors (pushdown unit)."""
        if isinstance(self, BinOp) and self.op == "&":
            return self.left.conjuncts() + self.right.conjuncts()
        return (self,)


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    """Reference to a named column of the view."""

    name: str

    def __call__(self, view):
        return view[self.name]

    def columns(self):
        return frozenset((self.name,))

    def cache_token(self):
        return ("col", self.name)

    def rename_columns(self, mapping):
        return Col(mapping.get(self.name, self.name))

    def __repr__(self):
        return f"col({self.name!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    """Scalar constant.  The token carries the concrete Python type: ``1``,
    ``1.0`` and ``True`` compare equal but trace to different programs."""

    value: object

    def __call__(self, view):
        return self.value

    def columns(self):
        return frozenset()

    def cache_token(self):
        return ("lit", type(self.value).__name__, self.value)

    def rename_columns(self, mapping):
        return self

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    """Binary arithmetic / comparison / boolean operator."""

    op: str
    left: Expr
    right: Expr

    def __call__(self, view):
        a, b = self.left(view), self.right(view)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            a, b = _torch_operands(self.op, a, b)
        return _BIN_OPS[self.op](a, b)

    def columns(self):
        return self.left.columns() | self.right.columns()

    def cache_token(self):
        return ("bin", self.op, self.left.cache_token(),
                self.right.cache_token())

    def rename_columns(self, mapping):
        return BinOp(self.op, self.left.rename_columns(mapping),
                     self.right.rename_columns(mapping))

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Expr):
    """Boolean/bitwise negation."""

    child: Expr

    def __call__(self, view):
        return ~self.child(view)

    def columns(self):
        return self.child.columns()

    def cache_token(self):
        return ("not", self.child.cache_token())

    def rename_columns(self, mapping):
        return Not(self.child.rename_columns(mapping))

    def __repr__(self):
        return f"~{self.child!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class IsIn(Expr):
    """Membership in a fixed scalar set; dispatches numpy vs torch by operand
    type so the same node serves the host mask path and the traced path."""

    child: Expr
    values: Tuple

    def __call__(self, view):
        arr = self.child(view)
        if isinstance(arr, torch.Tensor):
            # compare at one explicit 64-bit type (torch.isin wants matching
            # dtypes); the value set goes up with the launch, no sync
            vals = np.asarray(self.values)
            wide = (torch.float64 if arr.dtype.is_floating_point
                    or vals.dtype.kind == "f" else torch.int64)
            return torch.isin(arr.to(wide),
                              torch.as_tensor(vals, dtype=wide,
                                              device=arr.device))
        return np.isin(arr, np.asarray(self.values))

    def columns(self):
        return self.child.columns()

    def cache_token(self):
        return ("isin", self.child.cache_token(),
                tuple((type(v).__name__, v) for v in self.values))

    def rename_columns(self, mapping):
        return IsIn(self.child.rename_columns(mapping), self.values)

    def __repr__(self):
        return f"{self.child!r}.isin({list(self.values)!r})"


class CombinedPredicate:
    """AND of predicate parts where at least one is an opaque callable (an
    all-``Expr`` conjunction stays a single ``BinOp`` tree instead).

    The planner merges a fragment's filters into one predicate; wrapping
    mixed parts in an ad-hoc lambda would give every planned query a fresh
    code object and defeat the fused pipeline's predicate cache (one
    re-trace + one retained compiled program per ``collect()``).  This
    class keeps the parts addressable so ``fused._predicate_key`` can
    compose a stable key from the per-part keys."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def __call__(self, view):
        mask = self.parts[0](view)
        for p in self.parts[1:]:
            mask = mask & p(view)
        return mask

    def __repr__(self):
        return " & ".join(repr(p) if isinstance(p, Expr) else "<fn>"
                          for p in self.parts)


def col(name: str) -> Col:
    """Column reference: the entry point of the expression language."""
    return Col(name)


def lit(value) -> Lit:
    """Explicit scalar literal (operators auto-coerce plain scalars)."""
    return _coerce(value)
