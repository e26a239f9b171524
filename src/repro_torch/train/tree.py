"""Nested-dict trees of tensors: the few ``jax.tree_util`` operations the
training path needs.

A tree is a dict (nested to any depth) whose leaves are tensors or other
non-dict values.  Keys are visited in sorted order, the order in which
``jax.tree_util`` flattens a dict, so a leaf's position, its path and the
order of a sum over leaves are the reference's.  An empty dict has no
leaves.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_map_with_path", "tree_leaves",
           "tree_flatten_with_path", "tree_unflatten"]


def tree_map_with_path(fn: Callable, tree, *rest, _path: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` at each leaf of ``tree``; ``rest``
    are trees of the same structure.  ``path`` is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      _path=_path + (k,))
                for k in sorted(tree)}
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_flatten_with_path(tree, _path: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], _path + (k,))]
    return [(_path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
