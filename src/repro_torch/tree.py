"""Minimal pytree helpers for nested dicts/lists/tuples of tensors (the
parameter, cache and optimizer-state trees; a named tuple keeps its
type). Dict leaves are visited in sorted-key order, as ``jax.tree.leaves``
does, so the two packages' leaves line up."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure holding ``leaves``, in ``tree_leaves``
    order: the inverse of ``tree_leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
