"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameter, gradient and optimizer-state trees are plain nested dicts with
tensors (or ``None``: a leaf that received no gradient) at the leaves;
iteration follows dict order, as the JAX package's sorted trees do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_items(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs, depth first in dict order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_from_items(items) -> dict:
    """Inverse of :func:`tree_items` for a non-empty list of items."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
