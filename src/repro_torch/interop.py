"""Weights from the JAX package: nested dicts of numpy arrays → tensors.

The JAX package's parameter and artifact trees are plain nested dicts;
``jax.device_get`` turns them into numpy arrays, and these helpers carry them
across without importing jax.  bfloat16 arrays (``ml_dtypes``) travel as
their raw 16-bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_numpy_tree(tree: Any, device=None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays → the same tree of tensors
    on ``device`` (``None`` → the card)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        return _to_tensor(node, dev)

    return walk(tree)
