"""Sharding policies: a spec per tensor of a tree, per (arch × shape × mesh)
— the JAX package's ``sharding/partition.py`` rule table, ported as it
stands.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over their product, the first major).  :func:`to_placements` turns a
spec into DTensor placements on a ``DeviceMesh``.  A mesh here is anything
with named axis sizes: a ``DeviceMesh`` (``mesh_dim_names``), or any
object whose ``shape`` maps names to sizes, since the rules read nothing
else.

Axes: ``pod``/``data`` = pure DP (+FSDP over ``data``); ``model`` = TP/EP.
Rules are path-based (the parameter names are the JAX package's) with a
divisibility-aware helper, so head/expert/vocab padding interacts safely
with any mesh:

- Megatron TP: qkv/up col-parallel, o/down row-parallel, vocab-sharded
  embed+head; experts EP-sharded on ``model``; FSDP on ``data`` for
  weights, optimizer state and the (frozen) teacher.
- decode: batch→DP; KV cache sequence-sharded over ``model`` when kv-heads
  don't divide TP; SSM state head-sharded.
- quant-DoF vectors (log_s*, streams, norms, biases) replicated.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

from ..models.config import ModelConfig
from ..tree import tree_from_items, tree_items

Spec = tuple


def _sizes(mesh) -> Mapping:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= axis_size(mesh, n)
        return out
    return _sizes(mesh)[name]


def div_axes(size: int, axes, mesh):
    """Longest prefix of ``axes`` whose product divides ``size`` (or None)."""
    if isinstance(axes, str):
        axes = (axes,)
    chosen: list = []
    prod = 1
    for a in axes:
        if size % (prod * axis_size(mesh, a)) == 0:
            chosen.append(a)
            prod *= axis_size(mesh, a)
        else:
            break
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Axis-name knobs; the perf pass tunes these per cell."""
    dp: tuple[str, ...] = ("data",)          # ("pod","data") multi-pod
    tp: str = "model"
    fsdp: str | None = "data"                # None → pure DP (no ZeRO)
    fsdp_teacher: bool = True
    seq_shard_cache: bool = True    # decode KV seq over tp if heads < tp
    remat: bool = True


def _last_keys(path) -> list[str]:
    return [str(k) for k in path]


# weights whose OUT dim is TP-sharded (col-parallel) / IN dim (row-parallel)
_COL = {"wq", "wk", "wv", "up", "gate", "q_up", "k_up", "v_up", "in_proj",
        "shared_up", "shared_gate"}
_ROW = {"wo", "down", "out_proj", "shared_down"}
_REPL_LIN = {"router", "q_down", "kv_down", "frame_proj"}   # small in+out


def param_spec(path, leaf, cfg: ModelConfig, mesh,
               pol: ShardingPolicy) -> Spec:
    """The spec of the parameter at ``path`` (a tuple of keys) with
    ``leaf.shape``."""
    keys = _last_keys(path)
    name = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    tp, fsdp = pol.tp, pol.fsdp

    def spec(*dims):
        # pad leading axes (layer/group stacking) with None
        return tuple([None] * (nd - len(dims)) + list(dims))

    if name in ("w", "q"):
        # "w": training master weights; "q": exported (possibly int4-packed,
        # in-dim halved) deployment weights — same layout rules apply.
        fs = None if fsdp is None or name == "q" else fsdp
        if parent == "embed":
            return (div_axes(shape[0], tp, mesh),
                    div_axes(shape[1], fs, mesh) if fs else None)
        if parent == "lm_head":
            return (div_axes(shape[0], fs, mesh) if fs else None,
                    div_axes(shape[1], tp, mesh))
        is_expert = (parent in ("up", "gate", "down") and nd >= 3
                     and "mlp" in keys and cfg.moe is not None)
        if is_expert:
            # [L, E, in, out] (or [E, in, out]): EP on experts
            ein = div_axes(shape[-2], fs, mesh) if fs else None
            return spec(div_axes(shape[-3], tp, mesh), ein, None)
        if parent in _COL:
            return spec(div_axes(shape[-2], fs, mesh) if fs else None,
                        div_axes(shape[-1], tp, mesh))
        if parent in _ROW:
            return spec(div_axes(shape[-2], tp, mesh),
                        div_axes(shape[-1], fs, mesh) if fs else None)
        if parent in _REPL_LIN:
            return spec(div_axes(shape[-2], fs, mesh) if fs else None, None)
        # conv / unknown: replicate
        return (None,) * nd
    # scale vectors (s_wl/s_wr/log_*) are O(channels): replicate
    if name == "conv_w":
        return spec(None, div_axes(shape[-1], tp, mesh))
    return (None,) * nd


def params_shardings(params, cfg: ModelConfig, mesh,
                     pol: ShardingPolicy) -> Any:
    """A tree of specs with ``params``' structure (tensors, ``meta``
    tensors or anything with a ``shape``)."""
    return tree_from_items((p, param_spec(p, leaf, cfg, mesh, pol))
                           for p, leaf in tree_items(params))


def opt_state_shardings(params_shardings_tree, mesh) -> dict:
    """m/v mirror the param shardings (ZeRO: state sharded like weights)."""
    return {"m": params_shardings_tree, "v": params_shardings_tree,
            "step": ()}


def batch_shardings(batch, mesh, pol: ShardingPolicy) -> dict:
    """Each batch leaf split on axis 0 over the ``dp`` axes."""
    return {k: (div_axes(v.shape[0], pol.dp, mesh),)
            + (None,) * (len(v.shape) - 1) for k, v in batch.items()}


def cache_shardings(cache, cfg: ModelConfig, mesh,
                    pol: ShardingPolicy) -> Any:
    """Decode/prefill caches. KV: [L, B, S, Hkv, hd]; MLA: [L, B, S, lat];
    SSM state: [L, B, H, P, N]; conv: [L, B, k, cd]."""
    tp, dp = pol.tp, pol.dp

    def one(path, leaf):
        name = _last_keys(path)[-1]
        if name == "pos":                # a scalar, or one per slot
            return ()
        shape = tuple(leaf.shape)
        if name in ("k", "v"):           # [L, B, S, Hkv, hd]
            b = div_axes(shape[1], dp, mesh)
            h = div_axes(shape[3], tp, mesh)
            if h is not None:
                return (None, b, None, h, None)
            s = div_axes(shape[2], tp, mesh) if pol.seq_shard_cache else None
            return (None, b, s, None, None)
        if name in ("ckv", "kr"):        # [L, B, S, lat]
            b = div_axes(shape[1], dp, mesh)
            s = div_axes(shape[2], tp, mesh) if pol.seq_shard_cache else None
            return (None, b, s, None)
        if name == "ssm_state":          # [..., B, H, P, N]
            nd = len(shape)
            b = div_axes(shape[-4], dp, mesh)
            h = div_axes(shape[-3], tp, mesh)
            return (None,) * (nd - 4) + (b, h, None, None)
        if name == "conv_state":         # [..., B, k, cd]
            nd = len(shape)
            b = div_axes(shape[-3], dp, mesh)
            c = div_axes(shape[-1], tp, mesh)
            return (None,) * (nd - 3) + (b, None, c)
        return (None,) * len(shape)

    return tree_from_items((p, None if leaf is None else one(p, leaf))
                           for p, leaf in tree_items(cache))


def spec_at(specs, path: tuple) -> Spec:
    """The spec at ``path`` of a spec tree (a spec is itself a tuple, so
    ``tree.tree_items`` would walk into it)."""
    for k in path:
        specs = specs[k]
    return specs


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): mesh
    dimension ``i`` shards the tensor dimension whose entry names its axis
    (``Shard(d)``), else replicates.  A tensor dimension over ``("pod",
    "data")`` is ``Shard(d)`` on both, split pod-major as the JAX
    package's ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    owner: dict = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)
