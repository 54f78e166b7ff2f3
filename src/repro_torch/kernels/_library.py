"""The CUDA kernels as ``torch.library`` operators (namespace
``repro_torch``).

Each kernel entry is one operator with a CUDA implementation (the ctypes
launch, where its launch count is kept) and a fake one that gives only the
output's shape and type.  A trace of the card's route over fake tensors
(``FakeTensorMode``, ``make_fx``) then records each kernel as one graph
node, the counterpart of ``pallas_call`` in a jaxpr, without a card, an
allocation or a launch.  The wrappers call an operator only for CUDA
tensors (and fake meta ones in a trace, :func:`on_card`); CPU tensors take
the plain versions without it.
"""
from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

#: operator name → the kernel it launches (``csrc/<kernel>.cu``)
KERNEL_OPS: dict[str, str] = {}


def define(name: str, schema: str, cuda: Callable, fake: Callable,
           kernel: str):
    """Define ``repro_torch::<name><schema>`` with its CUDA and fake
    implementations; returns the operator's overload."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    KERNEL_OPS[name] = kernel
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def on_card(t: torch.Tensor) -> bool:
    """Whether a tensor takes the kernels' route: a CUDA tensor, or a fake
    tensor on the meta device (a trace of the card's route: its kernels
    are the operators' fake implementations — how a trace records the
    card's route on a CPU build of torch, whose autograd engine and some of
    whose operators refuse CUDA tensors, fake ones included).  A plain meta
    tensor does not: a wrapper refuses it."""
    from torch._subclasses.fake_tensor import FakeTensor
    return t.device.type == "cuda" or (t.device.type == "meta"
                                       and isinstance(t, FakeTensor))


def kernel_of(target) -> str | None:
    """The kernel a graph node's target launches, or None for any other
    operator."""
    name = getattr(target, "name", None)
    qual = name() if callable(name) else str(target)
    ns, _, rest = qual.partition("::")
    if ns != NAMESPACE:
        return None
    return KERNEL_OPS.get(rest.split(".")[0])
