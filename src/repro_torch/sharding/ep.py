"""Expert-parallel MoE dispatch over ``torch.distributed`` (the JAX package's
``sharding/ep.py``).

Tokens enter the block sequence-split over the ``model`` group, so each
rank of a data group routes a distinct slice of ``S / tp`` positions with a
purely local sort, and only expert buffers move — one all-to-all pair on
the model group per layer:

  1. local top-k routing + sort-based capacity dispatch (``models.moe.
     moe_sorted``, capacity from the local token count) → buf ``[E, C, d]``;
  2. all-to-all over ``model``: every expert block to its home rank,
     ``[E, C, d] → [E_loc, tp·C, d]``;
  3. the local quantized expert FFN (``core.dof`` through
     ``models.moe._expert_ffn``) on the rank's ``E_loc`` experts;
  4. the reverse all-to-all; the local weighted combine; the slices
     gathered back to ``[B, S, d]``.

Differentiable end to end: each exchange is an ``autograd.Function``
whose backward is the reverse all-to-all; the sequence split's backward
gathers the slices' gradients and the gather's backward keeps the rank's
own slice.  The expert path is not repeated over the model group — each
rank routes its own tokens — so each rank's gradient of the block's
parameters is a partial sum over ``model``; they pass Megatron's *f*
(``sharding.tp.copy_to``: an all-reduce over ``model`` backward), so every
rank holds the group's whole gradient, as the sharded train step
(``launch.train``) takes a block gathered whole (``sharding.tp.gather``).

Decode steps (``S`` not divisible by ``tp``) return None: the in-graph
path runs.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from ..models import moe as moe_lib
from ..models.config import ModelConfig
from . import tp as tp_lib

Params = dict[str, Any]


class _Exchange(torch.autograd.Function):
    """``dispatch``: ``[E, C, d]`` (expert-major, ``E = tp·E_loc``) →
    ``[E_loc, tp·C, d]``, each rank's rows of its experts from every
    rank; ``combine``: the inverse.  Each is the other's backward."""

    @staticmethod
    def forward(ctx, x, group, tp: int, dispatch: bool):
        ctx.group, ctx.tp, ctx.dispatch = group, tp, dispatch
        return _exchange(x, group, tp, dispatch)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.tp, not ctx.dispatch), None, \
            None, None


def _exchange(x: torch.Tensor, group, tp: int, dispatch: bool):
    if dispatch:
        E, C, d = x.shape
        send = x.reshape(tp, E // tp, C, d).contiguous()
    else:
        E_loc, TC, d = x.shape
        C = TC // tp
        send = x.reshape(E_loc, tp, C, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if dispatch:            # recv[i]: rank i's rows of this rank's experts
        return recv.transpose(0, 1).reshape(E // tp, tp * C, d)
    return recv.reshape(tp * E_loc, C, d)


class _SplitSeq(torch.autograd.Function):
    """This rank's slice of the sequence axis; backward gathers the
    slices' gradients, so the input's gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, group, tp: int, rank: int):
        ctx.group, ctx.tp = group, tp
        n = x.shape[1] // tp
        return x[:, rank * n:(rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.tp), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The slices gathered back along the sequence axis; backward keeps
    this rank's slice (every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, tp: int, rank: int):
        ctx.rank, ctx.n = rank, x.shape[1]
        return _gather_seq(x, group, tp)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.rank
        return g[:, r * n:(r + 1) * n].contiguous(), None, None, None


def _gather_seq(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def make_ep_moe(mesh, cfg: ModelConfig, qcfg: QuantConfig | None,
                dp_axes=("data",), tp_axis: str = "model", plan=None):
    """Returns ``moe_fn(x [B, S, d], layer_params, use_kernels) -> y [B, S,
    d]`` (or None); register it with ``models.transformer.set_runtime(
    moe_fn=)`` to replace the routed-experts path.

    ``mesh``: a ``DeviceMesh`` with ``tp_axis``; ``x`` is this rank's rows
    of the batch (its split over ``dp_axes`` happened before the forward).
    ``plan``: the resolved QuantPlan — the expert and router bits are
    looked up at ``layers.mlp``, as the in-graph path does.  A layer whose
    experts carry no quant DoF (the FP teacher) runs with ``qcfg`` None.
    ``use_kernels`` is the calling forward's route (``models.moe.
    moe_block`` passes its own): the experts' fake-quant takes the kernel
    route (``fake_quant`` for CUDA tensors, its plain version on the CPU)
    when it is set.
    """
    pv = plan_view(plan).child("layers", "mlp")
    e = cfg.moe
    tp = mesh.size(mesh.mesh_dim_names.index(tp_axis))
    group = mesh.get_group(tp_axis)
    rank = mesh.get_local_rank(tp_axis)
    E = e.n_experts_padded
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} ranks")
    E_loc = E // tp
    lo = rank * E_loc

    def local_experts(node):
        return {k: local_experts(v) if isinstance(v, dict)
                else v[lo:lo + E_loc] for k, v in node.items()}

    def moe_fn(x: torch.Tensor, p: Params, use_kernels: bool = False):
        B, S, d = x.shape
        if S % tp:                    # decode: trivial dispatch, baseline
            return None
        q = qcfg if isinstance(p.get("up"), dict) and "log_swr" in p["up"] \
            else None
        ep = {k: v for k, v in p.items() if not k.startswith("shared_")}
        if tp > 1:
            ep = {k: _copy_tree(v, group) for k, v in ep.items()}
            x = _SplitSeq.apply(x, group, tp, rank)
        shard = {**ep, **{k: local_experts(ep[k])
                          for k in ("up", "gate", "down")}}

        def expert_fn(buf):
            h = _Exchange.apply(buf, group, tp, True) if tp > 1 else buf
            y = moe_lib._expert_ffn(h, shard, cfg, q, plan=pv,
                                    use_kernels=use_kernels)
            return _Exchange.apply(y, group, tp, False) if tp > 1 else y

        Bl, Sl, _ = x.shape
        y = moe_lib.moe_sorted(x.reshape(Bl * Sl, d), ep, cfg, q,
                               expert_fn=expert_fn, plan=pv,
                               use_kernels=use_kernels).reshape(Bl, Sl, d)
        return _GatherSeq.apply(y, group, tp, rank) if tp > 1 else y

    return moe_fn


def _copy_tree(node, group):
    if isinstance(node, dict):
        return {n: _copy_tree(v, group) for n, v in node.items()}
    return tp_lib.copy_to(node, group)
