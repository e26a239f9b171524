"""Scan over a stacked leading axis, as a plain loop (torch).

The reference's ``scanctl.scan`` is ``jax.lax.scan`` with an ``UNROLL``
switch that only changes how XLA's ``cost_analysis`` counts a loop body
(its docstring); eager PyTorch has no compiled loop to count, so the port
keeps no counterpart of ``UNROLL``.  ``scan`` runs ``body`` once for each
index of the leading axis of ``xs`` (a nested dict / tuple of tensors) and
stacks what it returns.  The slices it hands ``body`` are views, so a body
that writes into one writes into the stacked tensor: the decode path
updates its caches that way (``models/lm.py``).  A leaf that requires grad
(a stacked parameter under training) is split once with ``unbind``, whose
backward stacks the slices' gradients in one copy; indexing it once a
step would make each step's backward a zero-filled copy of the whole
stacked leaf.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["scan", "stack"]


def _length(tree) -> int | None:
    """The leading axis of the first tensor in ``tree`` (None: none)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            n = _length(leaf)
            if n is not None:
                return n
        return None
    return tree.shape[0]


def _split(tree):
    """Each tensor of ``tree`` as its leading-axis slices: ``unbind`` where
    it requires grad, a lazy index (views that accept in-place writes)
    otherwise."""
    if isinstance(tree, dict):
        return {k: _split(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v) for v in tree)
    return _Rows(tree.unbind(0) if tree.requires_grad else tree)


class _Rows:
    """One leaf's slices: ``rows[i]`` of a tensor or of its unbind."""

    def __init__(self, rows):
        self.rows = rows


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, i) for v in tree)
    return tree.rows[i]


def stack(trees: list):
    """Stack same-shaped trees leaf by leaf along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack([t[j] for t in trees])
                           for j in range(len(first)))
    return torch.stack(trees)


def scan(body: Callable[[Any, Any], tuple[Any, Any]], init, xs):
    """``lax.scan(body, init, xs)``: returns (carry, stacked ys), ys None
    when ``body`` returns None for them."""
    carry, ys = init, []
    parts = _split(xs)
    for i in range(_length(xs) or 0):
        carry, y = body(carry, _take(parts, i))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, stack(ys)
