"""Device meshes over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's shapes and
axis names, on ``"cuda"`` unless the caller asks for ``"cpu"`` (the ``gloo``
path the CPU tests take).  The process group must already be initialised
(``torch.distributed.init_process_group`` with an explicit address, world
size and rank): nothing here guesses a cluster.

The reference's ``mesh_context`` has no counterpart: a DTensor carries its
mesh, so there is no ambient mesh to install.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               device_type: str | None) -> DeviceMesh:
    """A mesh of ``shape`` over ranks ``0 .. prod(shape) - 1``; the world
    may hold more ranks (stragglers an elastic remesh leaves out)."""
    dev = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group(init_method=..., "
                           "world_size=..., rank=...) first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    if n == world:
        return init_device_mesh(dev, shape, mesh_dim_names=axes)
    return DeviceMesh(dev, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """16 × 16 (``data``, ``model``), or 2 × 16 × 16 (``pod``, ``data``,
    ``model``) with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs exactly {n} "
                         f"ranks; the world has {dist.get_world_size()}")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str | None = None) -> DeviceMesh:
    """A 1 × 1 (``data``, ``model``) mesh: one rank."""
    return _make_mesh((1, 1), ("data", "model"), device_type)


def make_elastic_mesh(n_devices: int, model_parallel: int = 16,
                      device_type: str | None = None) -> DeviceMesh:
    """The largest (``data``, ``model``) mesh from ``n_devices`` survivors
    (elastic restarts, ``train/elastic.py``): ``model`` is
    ``min(model_parallel, n_devices)``, ``data`` the whole number of model
    groups that fit; stragglers that break divisibility are dropped."""
    model_parallel = min(model_parallel, n_devices)
    data = n_devices // model_parallel
    return _make_mesh((data, model_parallel), ("data", "model"), device_type)
