"""Nested parameter trees: the port's stand-in for ``jax.tree``.

Parameter, gradient and optimizer-state trees are plain nested dicts and
lists (the CNN's ``convs``/``streams``) with tensors (or ``None``: a leaf
that received no gradient) at the leaves; iteration follows dict order, as
the JAX package's sorted trees do, and list order.  A list position is a
path entry of its own (an ``int``), as ``jax.tree`` keys it.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_items(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs, depth first in dict and list order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_from_items(items) -> Any:
    """Inverse of :func:`tree_items` for a non-empty list of items: an
    ``int`` path entry makes a list."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)
