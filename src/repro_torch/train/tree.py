"""Nested dicts, lists and tuples of tensors: the port's parameter and
optimizer-state trees, walked as ``jax.tree`` walks the reference's.  A
leaf is anything that is not a dict, list, tuple or None (None is an
empty subtree, as in JAX); dict keys are visited in sorted order, as
``jax.tree_util`` visits them, so a path names the same leaf in both
packages."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths", "tree_unflatten"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure;
    the leaves are visited in :func:`tree_paths` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):  # visited in tree_paths' order
        built = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                 for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: a dict key is
    its string, a list or tuple position its index as a string."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template, leaves: List[Any]):
    """A tree of ``template``'s structure holding ``leaves`` in
    :func:`tree_paths` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(template)
