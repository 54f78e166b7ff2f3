"""Gradient compression for data-parallel traffic: int8 with error feedback
— the paper's own quantization machinery applied to the collectives.

Each step quantizes the local gradient plus the carried residual to an
int8 grid (one scale a tensor, ``max|g + e| / 127``, rounded half to even),
hands on the dequantized gradient and keeps the new residual in a bf16
error-feedback buffer (Seide et al. / 1-bit-SGD style), added back next
step.  The arithmetic is the JAX package's ``train/compression.py``,
operation for operation, in f32.  A ``None`` gradient (a leaf no gradient
reached) stays ``None`` and its buffer stays zero, as the JAX package's
zero gradient would leave it.

:func:`error_feedback_hook` wraps a compressor as ``train.steps.
make_train_step``'s ``grad_compress`` hook, which carries its own buffer
(the optimizer's state holds only Adam's ``m``, ``v`` and ``step``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..tree import tree_from_items, tree_items, tree_map


def make_error_feedback_compressor(bits: int = 8) -> tuple[Callable,
                                                            Callable]:
    """``(init, compress)``: ``init(params) -> {"ef": bf16 zeros}``;
    ``compress(grads, ef_state) -> (dequantized grads, {"ef": ...})``."""
    qmax = float(2 ** (bits - 1) - 1)

    def init(params) -> dict:
        return {"ef": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.bfloat16), params)}

    def one(g, e):
        gf = g.to(torch.float32) + e.to(torch.float32)
        scale = torch.clamp(gf.abs().max() / qmax, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
        deq = (q * scale).to(g.dtype)
        return deq, (gf - deq).to(torch.bfloat16)

    def compress(grads, ef_state) -> tuple[Any, dict]:
        ef = dict(tree_items(ef_state["ef"]))
        out = {path: (None, ef[path]) if g is None else one(g, ef[path])
               for path, g in tree_items(grads)}
        return (tree_from_items((p, o[0]) for p, o in out.items()),
                {"ef": tree_from_items((p, o[1]) for p, o in out.items())})

    return init, compress


def error_feedback_hook(params, bits: int = 8) -> Callable:
    """``hook(grads, opt_state) -> (grads, opt_state)`` for
    ``make_train_step(grad_compress=)``: compresses with its own
    error-feedback buffer (``hook.state["ef"]``), leaving ``opt_state`` as
    it is."""
    init, compress = make_error_feedback_compressor(bits)

    def hook(grads, opt_state):
        grads, hook.state = compress(grads, hook.state)
        return grads, opt_state

    hook.state = init(params)
    return hook
