"""Tensor parallelism over ``model`` inside the sharded QFT step: Megatron's
layout, as the JAX package's GSPMD computes its ``sharding/partition.py``
placements.

A rank of a ``model`` group computes its own slice of a dense layer:

- column-parallel ``wq``/``wk``/``wv``/``gate``/``up``: the replicated
  normed residual times the rank's output columns, after Megatron's *f*
  (:func:`copy_to`: identity forward, all-reduce over ``model`` backward);
- row-parallel ``wo``/``down``: the rank's activations times its input
  rows, a partial sum, then *g* (:func:`reduce_from`: all-reduce forward,
  identity backward); a bias is added once, after the reduce;
- attention on the rank's query heads.  With fewer KV heads than ranks a
  KV head's columns lie on ``tp / Hkv`` ranks: those ranks gather the
  weight's columns among themselves (:func:`gather_kv`, a reduce-scatter
  backward), never the whole ``wk``/``wv``.  The weight, not the k/v
  activations: at a train shape the head's ``[d, hd]`` columns are far
  fewer bytes than ``[B, S, hd]``, and the fake-quant being elementwise the
  gathered columns quantize to the whole weight's bits;
- the embedding by vocabulary rows: each rank looks up its rows, masks the
  tokens outside them, and *g* sums the group's rows.

Leaves are stored as ``sharding.partition`` places them; a rank's views
are taken where a layer uses them (:func:`layer_view`, inside the remat
region): a ``model``-sharded weight keeps its shard and is gathered over
the other axes only; a replicated leaf is taken whole and sliced as its
weight's shard needs (``core.dof.shard_qlinear``, ``shard_stream``).

**The deployed artifact** (the serving cells): an exported linear's ``q``
(nibble-packed along the in-dim or int8) is stored over ``model`` only,
its ``s_wl``/``s_wr``/bias replicated; the view dequantizes the rank's
shard with its slices of the scales (``core.dof.shard_export``,
``deploy_node``), an exported embedding's rows times their ``s``, the
``lm_head``'s vocabulary columns (:func:`head_view`), so the logits are
the rank's slice of the vocabulary.  No gradient is taken there.  A
forward with a cache takes the cache's DTensor leaves as the rank's
shards (:func:`cache_view`), the k/v split over ``model`` by KV heads, by
the sequence, or not at all (``Group.kv``); ``models.attention`` then
gathers this step's k/v activations where it needs them, never a weight.
On that artifact MoE runs on the rank's experts (each stack's ``q`` split
over ``model`` by experts, the shared experts column- and row-parallel, the
router whole; one *g* a layer) and MLA on the rank's heads (``q_up``,
``k_up``, ``v_up`` its columns, ``wo`` its rows, ``q_down``/``kv_down``
whole), its latent ``ckv``/``kr`` split over the sequence or whole; in the
default form over a sequence split ``k_up``/``v_up`` are the one weight
gathered over ``model``, to expand the rank's chunk for every head.

**The gradient rule** (:data:`SHARD`, :data:`PARTIAL`, :data:`WHOLE`):
each view declares how the rank's gradient of the leaf relates to its
``model`` group's, as the placement on ``model`` of the view's gradient.
Over the ``dp`` axes it is always a partial sum (each rank holds its rows
of the batch), so the step's gradients are the sums over ``dp`` divided by
the ``dp`` size (``launch.train.sharded_value_and_grad``):

- ``SHARD``: a ``model``-sharded weight computed on its shard: the rank's
  gradient is the group's for its rows or columns;
- ``PARTIAL``: a replicated leaf that only the rank's share reaches (a
  sliced ``log_swr`` or bias, a stream's ``log_sa``/``zp`` through S_wL and
  the activation fake-quant before *f*, ``q_norm``/``k_norm`` on the
  rank's heads, the embedding's ``log_s``): summed over ``model``;
- ``WHOLE``: a leaf every rank of the group computes in full — what sees
  the replicated residual after *f*'s backward (``norm1``, ``norm2``,
  ``final_norm``), a row-parallel bias, and every leaf of a block that is
  gathered whole (:func:`gather`).

At ``model`` size 1 nothing here runs: :func:`gather` takes today's whole
gather, every gradient a partial sum over every axis (``launch.train``
divides by the mesh size, which is then the ``dp`` size).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..core import dof

#: the mesh axis that computes on shards
AXIS = "model"

#: the view kinds of the gradient rule (see the module docstring)
SHARD, PARTIAL, WHOLE = "shard", "partial", "whole"


def _dtensor_mod():
    from torch.distributed import tensor
    return tensor


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _wait(t: torch.Tensor) -> torch.Tensor:
    wait = getattr(t, "wait", None)
    return wait() if callable(wait) else t


def is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


def model_size(mesh) -> int:
    """The ``model`` axis's size on ``mesh`` (1 where it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(AXIS)) if AXIS in names else 1


# --------------------------------------------------------------------------
# f, g and the KV-group gather: functional collectives, so a make_fx trace
# records them (the dry-run counts their bytes)
# --------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _wait(_funcol().all_reduce(x.contiguous(), "sum", group))


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _collective(new: str, old: str):
    """A functional collective by its current name (``*_single``), or by
    the name older torch releases have."""
    f = _funcol()
    return getattr(f, new, None) or getattr(f, old)


class _GatherCols(torch.autograd.Function):
    """The ranks' column blocks side by side (all-gather on the last
    dimension); backward sums the gradient's blocks over the group and
    keeps the rank's (reduce-scatter)."""

    @staticmethod
    def forward(ctx, w, group, n: int):
        ctx.group, ctx.n = group, n
        gather = _collective("all_gather_single", "all_gather_tensor")
        parts = _wait(gather(w.movedim(-1, 0).contiguous(), 0, group))
        return parts.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        scatter = _collective("reduce_scatter_single",
                              "reduce_scatter_tensor")
        part = _wait(scatter(g.movedim(-1, 0).contiguous(), "sum", 0,
                             ctx.group))
        return part.movedim(0, -1).contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """*f* over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """*g* over ``group``."""
    return _ReduceFrom.apply(x, group)


def gather_kv(w: torch.Tensor, group, n: int) -> torch.Tensor:
    """``w``'s columns gathered over the ``n`` ranks of ``group`` (the
    ranks that hold one KV head between them)."""
    return _GatherCols.apply(w, group, n)


@dataclasses.dataclass(frozen=True)
class Group:
    """A rank's ``model`` group, for a block computed on shards: the
    compute side (``models.attention``, ``models.layers``) calls
    :meth:`copy_to` on a block's input and :meth:`reduce_from` on a
    row-parallel product; ``rank`` places the embedding's rows.  ``kv``
    says how a cache given with the group is split over it: ``"heads"``
    (each rank its KV heads), ``"seq"`` (each rank a chunk of the
    sequence) or None (each rank holds it whole)."""
    group: Any
    size: int
    rank: int
    kv: str | None = None

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The group's column blocks of an activation side by side."""
        return gather_kv(x, self.group, self.size)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` (``"sum"``, ``"max"``) over the group, no gradient."""
        return _wait(_funcol().all_reduce(x.contiguous(), op, self.group))


#: the KV groups made in a world: (the world's id, the ``model`` group's
#: ranks) → (the world, kept so its id is not reused; {ranks a head: group}).
#: Keyed by ranks, not by the process-group object: a DTensor's mesh may be
#: another mesh of the same ranks and names (DTensor's sharding cache
#: compares meshes by value), whose ``get_group`` answers another object
_KV_GROUPS: dict[tuple, tuple[Any, dict]] = {}


def _kv_group(mesh, s: int):
    """The process group of this rank's ``s`` consecutive ``model`` ranks
    (one KV head's).  Every rank makes every such group of the mesh, in
    the same order, the first time (``new_group`` is collective; reading
    the mesh's ranks is what a traced step cannot do, so :func:`prepare`
    makes them before)."""
    names = mesh.mesh_dim_names
    if names[-1] != AXIS:
        raise ValueError(f"the {AXIS!r} axis must be the mesh's last: "
                         f"{names}")
    world = dist.group.WORLD
    key = (id(world),
           tuple(dist.get_process_group_ranks(mesh.get_group(AXIS))))
    _, made = _KV_GROUPS.setdefault(key, (world, {}))
    if s not in made:
        ranks = mesh.mesh.reshape(-1, s).tolist()
        mine = None
        for r in ranks:
            g = dist.new_group(ranks=r)
            if dist.get_rank() in r:
                mine = g
        made[s] = mine
    return made[s]


def prepare(mesh, cfg) -> None:
    """Make the process groups the forward of ``cfg`` on ``mesh`` will ask
    for (the KV groups, where ``cfg`` has fewer KV heads than ``model``
    has ranks), so a traced step finds them made: making them reads the
    mesh's rank tensor, which a ``make_fx`` trace cannot.  A family with no
    attention (``n_kv_heads_padded`` 0) needs none."""
    size = model_size(mesh)
    hkv = cfg.n_kv_heads_padded
    if size > 1 and 0 < hkv < size and size % hkv == 0:
        _kv_group(mesh, size // hkv)


# --------------------------------------------------------------------------
# views: the rank's plain tensors of DTensor leaves, with the gradient rule
# --------------------------------------------------------------------------

def view(t, kind: str) -> torch.Tensor:
    """The rank's plain tensor of the DTensor ``t`` for a view of
    ``kind``: ``SHARD`` keeps ``t``'s ``model`` shard and gathers the other
    axes; ``PARTIAL`` and ``WHOLE`` gather ``t`` whole.  Where a gradient
    is taken, the view's gradient is declared a partial sum over every
    other axis and, over ``model``, the shard's (``SHARD``), a partial sum
    (``PARTIAL``) or the same on every rank (``WHOLE``)."""
    dt = _dtensor_mod()
    mesh = t.device_mesh
    m = mesh.mesh_dim_names.index(AXIS)
    keep = t.placements[m] if kind == SHARD else dt.Replicate()
    target = tuple(keep if i == m else dt.Replicate()
                   for i in range(mesh.ndim))
    t = t.redistribute(mesh, target)
    if not torch.is_grad_enabled():
        return t.to_local()
    on_model = {SHARD: keep, PARTIAL: dt.Partial(), WHOLE: dt.Replicate()}
    grad = tuple(on_model[kind] if i == m else dt.Partial()
                 for i in range(mesh.ndim))
    return t.to_local(grad_placements=grad)


def gather(tree, dtype=None):
    """``tree`` with each DTensor leaf gathered to its whole value (a plain
    tensor); plain leaves are kept.  With ``dtype`` an exported linear or
    embedding among them (``core.dof.is_exported``) is taken as its deploy
    view, the weight dequantized to ``dtype`` (``core.dof.deploy_node``).
    On a mesh whose ``model`` axis has more than one rank the gather's
    gradient is ``WHOLE`` (every rank of the group runs the block in
    full); else a partial sum over every axis, the gather at ``model``
    size 1."""
    if isinstance(tree, dict):
        out = {k: gather(v, dtype) for k, v in tree.items()}
        if dtype is not None and dof.is_exported(out):
            return dof.deploy_node(out, dtype)
        return out
    if not is_dtensor(tree):
        return tree
    if model_size(tree.device_mesh) > 1:
        return view(tree, WHOLE)
    from torch.distributed.tensor import Partial
    if not torch.is_grad_enabled():
        return tree.full_tensor()
    return tree.full_tensor(
        grad_placements=(Partial(),) * tree.device_mesh.ndim)


def _model_shard_dim(t) -> int | None:
    """The tensor dimension ``t`` is sharded on over ``model`` (counted
    from the end, -1 or -2), or None."""
    from torch.distributed.tensor import Shard
    pl = t.placements[t.device_mesh.mesh_dim_names.index(AXIS)]
    return pl.dim - t.ndim if isinstance(pl, Shard) else None


def _group_of(tree) -> tuple[Any, Group] | None:
    """``(mesh, Group)`` of the first DTensor leaf of ``tree`` on a mesh
    whose ``model`` axis has more than one rank, else None."""
    leaves = [tree] if not isinstance(tree, dict) else list(_leaves(tree))
    for t in leaves:
        if is_dtensor(t):
            mesh = t.device_mesh
            size = model_size(mesh)
            if size <= 1:
                return None
            return mesh, Group(mesh.get_group(AXIS), size,
                               mesh.get_local_rank(AXIS))
    return None


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _weight(p: dict):
    """A linear's or embedding's weight leaf: the trained ``w`` or the
    exported ``q``."""
    return p["w"] if "w" in p else p["q"]


def _qlinear_view(p: dict, axis: str, rank: int, size: int,
                  w: torch.Tensor | None = None) -> dict:
    """A quantized linear's views on a ``"col"``/``"row"`` shard: the weight
    ``SHARD`` (or ``w``, a view made by the caller), the bias ``WHOLE`` on
    a row-parallel weight (added after the reduce), every other leaf
    ``PARTIAL``; then the scale DoF and bias sliced to the shard."""
    out = {}
    for k, t in p.items():
        if k == "w":
            out[k] = view(t, SHARD) if w is None else w
        else:
            out[k] = view(t, WHOLE if k == "b" and axis == "row"
                          else PARTIAL)
    return dof.shard_qlinear(out, axis, rank, size)


def _export_view(p: dict, axis: str, rank: int, size: int, dtype) -> dict:
    """An exported linear's deploy view on a ``"col"``/``"row"`` shard:
    the rank's ``q`` (stored on ``model`` only, so nothing is gathered),
    its slices of ``s_wl``/``s_wr`` and the bias, dequantized to
    ``dtype``.  No gradient is taken here."""
    if dtype is None:
        raise ValueError("an exported linear's view needs the dtype to "
                         "dequantize to")
    ex = {k: view(t, SHARD if k == "q" else WHOLE) for k, t in p.items()}
    return dof.deploy_node(dof.shard_export(ex, axis, rank, size), dtype)


def _linear_view(p: dict, axis: str, rank: int, size: int, dtype) -> dict:
    if "q" in p:
        return _export_view(p, axis, rank, size, dtype)
    return _qlinear_view(p, axis, rank, size)


def _stream_view(s: dict, rank: int | None = None, size: int = 1) -> dict:
    """A stream's ``PARTIAL`` views, sliced to the rank's channels when
    ``rank`` is given (a row-parallel weight's input stream)."""
    out = {k: view(t, PARTIAL) for k, t in s.items()}
    return out if rank is None else dof.shard_stream(out, rank, size)


def _attn_split(p: dict, hd: int, size: int) -> int | None:
    """How many ranks hold one KV head between them (1: each rank holds
    whole KV heads), or None where the attention block cannot run on
    shards: a weight not split on ``model`` as the layout has it, or heads
    that do not fall whole onto ranks."""
    dims = {n: _model_shard_dim(_weight(p[n]))
            for n in ("wq", "wk", "wv", "wo")}
    if dims != {"wq": -1, "wk": -1, "wv": -1, "wo": -2}:
        return None
    if _weight(p["wq"]).shape[-1] % (size * hd):
        return None
    cols = _weight(p["wk"]).shape[-1] // size
    if cols % hd == 0:
        return 1
    if hd % cols == 0 and size % (hd // cols) == 0:
        return hd // cols
    return None


def _attn_view(p: dict, g: Group, mesh, split: int, dtype,
               cache: bool) -> dict:
    out = {"wq": _linear_view(p["wq"], "col", g.rank, g.size, dtype),
           "wo": _linear_view(p["wo"], "row", g.rank, g.size, dtype)}
    # a KV head over several ranks: the trained weight's columns are
    # gathered over its ranks in a cache-free forward; an exported weight,
    # or any forward with a cache, keeps its column shard and the
    # attention gathers this step's k/v activations instead
    kv = (None if split == 1 or cache or "q" in p["wk"]
          else _kv_group(mesh, split))
    for n in ("wk", "wv"):
        if kv is None:
            out[n] = _linear_view(p[n], "col", g.rank, g.size, dtype)
        else:           # the whole KV head, from the ranks that share it
            w = gather_kv(view(p[n]["w"], SHARD), kv, split)
            out[n] = _qlinear_view(p[n], "col", g.rank // split,
                                   g.size // split, w=w)
    for n in ("q_norm", "k_norm"):
        if n in p:
            out[n] = {k: view(t, PARTIAL) for k, t in p[n].items()}
    if "in_stream" in p:
        out["in_stream"] = _stream_view(p["in_stream"])
    if "out_stream" in p:
        out["out_stream"] = _stream_view(p["out_stream"], g.rank, g.size)
    unknown = set(p) - set(out)
    if unknown:
        raise ValueError(f"attention leaves with no tensor-parallel view: "
                         f"{sorted(unknown)}")
    return out


def _mlp_fits(p: dict) -> bool:
    want = {"up": -1, "gate": -1, "down": -2}
    return all(_model_shard_dim(_weight(p[n])) == d
               for n, d in want.items()
               if n in p) and "up" in p and "down" in p


def _mlp_view(p: dict, g: Group, dtype) -> dict:
    out = {}
    for n in ("up", "gate"):
        if n in p:
            out[n] = _linear_view(p[n], "col", g.rank, g.size, dtype)
    out["down"] = _linear_view(p["down"], "row", g.rank, g.size, dtype)
    if "in_stream" in p:
        out["in_stream"] = _stream_view(p["in_stream"])
    if "act_stream" in p:
        out["act_stream"] = _stream_view(p["act_stream"], g.rank, g.size)
    unknown = set(p) - set(out)
    if unknown:
        raise ValueError(f"MLP leaves with no tensor-parallel view: "
                         f"{sorted(unknown)}")
    return out


def _mla_fits(p: dict, cfg, size: int) -> bool:
    """Whether an exported MLA block can run on the rank's heads: ``q_up``,
    ``k_up``, ``v_up`` split on ``model`` by columns, ``wo`` by rows, and
    its heads falling whole onto ranks."""
    want = {"q_up": -1, "k_up": -1, "v_up": -1, "wo": -2}
    if not all(dof.is_exported(p[n]) and _model_shard_dim(p[n]["q"]) == d
               for n, d in want.items()):
        return False
    m = cfg.mla
    return (p["q_up"]["q"].shape[-1] // (m.d_nope + m.d_rope)) % size == 0


def _mla_view(p: dict, g: Group, dtype, whole_up: bool) -> dict:
    """An exported MLA block on the rank's heads: ``q_up`` its heads'
    columns, ``wo`` their rows; ``k_up``/``v_up`` its heads' columns, or
    (``whole_up``: the default form over a cache split over the sequence,
    which expands the rank's chunk for every head) gathered whole over
    ``model`` and dequantized on the rank; ``q_down``, ``kv_down`` and the
    norms whole."""
    out = {"q_up": _export_view(p["q_up"], "col", g.rank, g.size, dtype),
           "wo": _export_view(p["wo"], "row", g.rank, g.size, dtype)}
    for n in ("k_up", "v_up"):
        out[n] = (gather(p[n], dtype) if whole_up
                  else _export_view(p[n], "col", g.rank, g.size, dtype))
    for n in ("q_down", "kv_down", "q_norm", "kv_norm"):
        out[n] = gather(p[n], dtype)
    unknown = set(p) - set(out)
    if unknown:
        raise ValueError(f"MLA leaves with no tensor-parallel view: "
                         f"{sorted(unknown)}")
    return out


#: an exported MoE block's expert stacks and its shared experts' split
_MOE_SPLIT = {"up": -3, "gate": -3, "down": -3, "shared_up": -1,
              "shared_gate": -1, "shared_down": -2}


def _moe_stacks(p: dict) -> bool | None:
    """Whether an exported MoE block runs on shards with its expert stacks
    split on ``model`` by experts (True) or whole (False, where the
    experts do not divide ``model``: then its shared experts, split by
    columns and rows, are what runs on shards); None where it cannot:
    leaves not exported or not split as the layout has them, or nothing
    split at all."""
    if not all(dof.is_exported(p[n]) for n in _MOE_SPLIT if n in p):
        return None
    dims = {n: _model_shard_dim(p[n]["q"]) for n in _MOE_SPLIT if n in p}
    stacks = {dims[n] for n in ("up", "gate", "down")}
    shared = [dims[n] == d for n, d in _MOE_SPLIT.items()
              if n.startswith("shared") and n in dims]
    if stacks not in ({-3}, {None}) or not all(shared) or (
            stacks == {None} and not shared):
        return None
    return stacks == {-3}


def _experts_view(ex: dict, rank: int, dtype) -> dict:
    """An exported expert stack ``q [E, in(/2), out]``'s deploy view on the
    rank's ``E/tp`` experts: its ``q`` shard, ``s_wr`` (and a bias) sliced
    to those experts, the stack's one ``s_wl [in]`` whole — the matching
    experts of the whole stack's dequantization, bit for bit."""
    if dtype is None:
        raise ValueError("an exported stack's view needs the dtype to "
                         "dequantize to")
    q = view(ex["q"], SHARD)
    n = q.shape[-3]
    out = {"q": q}
    for k, t in ex.items():
        if k != "q":
            t = view(t, WHOLE)
            out[k] = t[rank * n:(rank + 1) * n] if k in ("s_wr", "b") else t
    return dof.deploy_node(out, dtype)


def _moe_view(p: dict, g: Group, dtype, stacks: bool) -> dict:
    """An exported MoE block on the rank's shards: its experts of each
    stack (``stacks``; else, where the experts do not divide ``model``,
    every expert, gathered whole), the shared experts' column
    (``shared_up``/``shared_gate``) and row (``shared_down``) views, the
    router whole."""
    out = {n: _experts_view(p[n], g.rank, dtype) if stacks
           else gather(p[n], dtype) for n in ("up", "gate", "down")}
    for n in ("shared_up", "shared_gate", "shared_down"):
        if n in p:
            out[n] = _export_view(p[n], "row" if n == "shared_down"
                                  else "col", g.rank, g.size, dtype)
    out["router"] = gather(p["router"], dtype)
    unknown = set(p) - set(out)
    if unknown:
        raise ValueError(f"MoE leaves with no tensor-parallel view: "
                         f"{sorted(unknown)}")
    return out


def layer_view(lp: dict, cfg, dtype=None, cache: bool = False,
               kv: str | None = None
               ) -> tuple[dict, Group | None, Group | None]:
    """``(tree, attn, mlp)``: one layer's leaves as the rank computes them,
    and the ``Group`` its attention and its MLP run on shards over (None
    for a block gathered whole).  On shards: the dense attention where its
    four weights are split on ``model`` as the layout has them and its
    heads fall whole onto ranks (or one KV head over ``tp / Hkv`` ranks);
    the dense MLP where its weights are split so; and on the deployed
    artifact (exported leaves, no gradient) MLA on the rank's heads
    (:func:`_mla_view`) and the MoE block on the rank's experts and shared
    experts' columns (:func:`_moe_view`) where their leaves are split so —
    where the heads or the experts do not divide ``model``, ``param_spec``
    leaves them replicated, and MLA, or the routed experts, are then
    gathered whole.  Every other leaf is gathered whole
    (:func:`gather`).  An exported layer is dequantized to ``dtype`` here,
    each rank its own shard; ``cache`` says the forward holds a cache,
    ``kv`` how it is split over ``model`` (:func:`cache_view`)."""
    found = _group_of(lp)
    if found is None:
        return gather(lp, dtype), None, None
    mesh, g = found
    attn = mlp = None
    out = {}
    for k, v in lp.items():
        if k == "attn" and cfg.mla is None:
            split = _attn_split(v, cfg.head_dim, g.size)
            if split is not None:
                out[k] = _attn_view(v, g, mesh, split, dtype, cache)
                attn = g
                continue
        if k == "attn" and cfg.mla is not None and _mla_fits(v, cfg, g.size):
            whole_up = cache and kv == "seq" and not cfg.mla_absorb
            out[k], attn = _mla_view(v, g, dtype, whole_up), g
            continue
        if k == "mlp" and cfg.moe is None and _mlp_fits(v):
            out[k], mlp = _mlp_view(v, g, dtype), g
            continue
        stacks = (_moe_stacks(v) if k == "mlp" and cfg.moe is not None
                  else None)
        if stacks is not None:
            out[k], mlp = _moe_view(v, g, dtype, stacks), g
            continue
        out[k] = gather(v, dtype)
    return out, attn, mlp


def embed_view(p: dict, dtype=None) -> tuple[dict, Group | None]:
    """``(tree, group)``: the embedding's rows of this rank (``w``
    ``SHARD``, ``log_s``'s rows ``PARTIAL``; an exported table's ``q``
    rows times their ``s``) and its ``Group`` where the table is split by
    vocabulary rows over ``model``; else the whole table and None."""
    found = _group_of(p)
    if found is None or _model_shard_dim(_weight(p)) != -2:
        return gather(p, dtype), None
    _, g = found
    if "q" in p:
        q = view(p["q"], SHARD)
        rows = q.shape[0]
        out = dof.deploy_node({"q": q, "s": view(p["s"], WHOLE)[
            g.rank * rows:(g.rank + 1) * rows]})
        known = {"q", "s"}
    else:
        w = view(p["w"], SHARD)
        out = {"w": w}
        if "log_s" in p:
            rows = w.shape[0]
            out["log_s"] = view(p["log_s"], PARTIAL)[
                g.rank * rows:(g.rank + 1) * rows]
        known = set(out)
    unknown = set(p) - known
    if unknown:
        raise ValueError(f"embedding leaves with no tensor-parallel view: "
                         f"{sorted(unknown)}")
    return out, g


def head_view(p: dict, dtype=None) -> tuple[dict, Group | None]:
    """``(tree, group)``: the ``lm_head``'s vocabulary columns of this rank
    (so the logits are the rank's vocabulary slice) and its ``Group``
    where the weight is split so over ``model``; else the whole head and
    None."""
    found = _group_of(p)
    if found is None or _model_shard_dim(_weight(p)) != -1:
        return gather(p, dtype), None
    _, g = found
    return _linear_view(p, "col", g.rank, g.size, dtype), g


# --------------------------------------------------------------------------
# the cache of a forward on shards
# --------------------------------------------------------------------------

#: the cache leaves that may be split over ``model``, each dimension's
#: split: the k/v ``[L, B, T, Hkv, hd]`` by heads or the sequence, the MLA
#: latent ``ckv``/``kr`` ``[L, B, T, lat]`` by the sequence
_SPLITS = {("k",): {3: "heads", 2: "seq"}, ("v",): {3: "heads", 2: "seq"},
           ("ckv",): {2: "seq"}, ("kr",): {2: "seq"}}


def cache_view(cache) -> tuple[Any, str | None]:
    """``(local, kv)``: ``cache`` with each DTensor leaf replaced by the
    rank's local tensor — its rows of the batch, and its part over
    ``model`` — which shares the DTensor's storage, so the forward's
    in-place writes land in it; ``kv`` is how the top-level ``k``/``v``
    (or MLA's ``ckv``/``kr``) are split over ``model``: ``"heads"``,
    ``"seq"`` or None (whole).  No other leaf may be split over ``model``.
    A cache with no DTensor leaf is returned as it is."""
    if cache is None or not any(is_dtensor(t) for t in _leaves(cache)):
        return cache, None
    from torch.distributed.tensor import Shard
    kv = set()

    def local(node, path):
        if isinstance(node, dict):
            return {k: local(v, path + (k,)) for k, v in node.items()}
        if not is_dtensor(node):
            return node
        names = node.device_mesh.mesh_dim_names
        pl = node.placements[names.index(AXIS)] if AXIS in names else None
        if isinstance(pl, Shard) and model_size(node.device_mesh) > 1:
            if pl.dim not in _SPLITS.get(path, {}):
                raise ValueError(f"cache leaf {'.'.join(path)} is split "
                                 f"over {AXIS!r} on dimension {pl.dim}; "
                                 f"only the top-level k/v may be, on their "
                                 f"heads or sequence, and ckv/kr on their "
                                 f"sequence")
            kv.add(_SPLITS[path][pl.dim])
        elif path in _SPLITS:
            kv.add(None)
        return node.to_local()

    out = local(cache, ())
    if len(kv) > 1:
        raise ValueError(f"the cache's leaves are split differently: {kv}")
    return out, (kv.pop() if kv else None)


def sync_cache(cache, local) -> None:
    """Write ``local``'s plain entries (``pos``, a cross K/V the forward
    filled) back into ``cache``, whose DTensor leaves share storage with
    ``local``'s (:func:`cache_view`)."""
    if local is cache:
        return
    for k, v in local.items():
        if isinstance(v, dict) and isinstance(cache.get(k), dict):
            sync_cache(cache[k], v)
        elif not is_dtensor(cache.get(k)):
            cache[k] = v

