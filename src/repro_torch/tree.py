"""Minimal pytree helpers for nested dicts/lists/tuples of tensors (the
parameter, cache and optimizer-state trees; a named tuple keeps its
type). Dict leaves are visited in sorted-key order, as ``jax.tree.leaves``
does, so the two packages' leaves line up. The ``_with_path`` forms give
each leaf the path of ``DictKey``/``SequenceKey`` entries that JAX's
``tree_util`` gives it, which the sharding rules read."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple


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


class DictKey(NamedTuple):
    """A path entry for a dict key, JAX's ``DictKey``: ``.key``."""
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class SequenceKey(NamedTuple):
    """A path entry for a list or tuple position, JAX's ``SequenceKey``:
    ``.idx``."""
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx!r}]"


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any,
                       _path: Tuple = ()) -> Any:
    """``tree_map`` with ``fn(path, leaf)``: ``path`` is the tuple of
    ``DictKey``/``SequenceKey`` entries from the root to the leaf (a named
    tuple's fields count as positions)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], _path + (DictKey(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, t, _path + (SequenceKey(i),))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, _path + (SequenceKey(i),))
                          for i, t in enumerate(tree))
    return fn(_path, tree)


def tree_leaves_with_path(tree: Any) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order."""
    out: List[Tuple[Tuple, Any]] = []
    tree_map_with_path(lambda p, l: out.append((p, l)), tree)
    return out
