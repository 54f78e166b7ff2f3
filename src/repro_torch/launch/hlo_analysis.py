"""The dry-run's accounting, read from FX graphs (the JAX package's
``launch/hlo_analysis.py`` reads compiled HLO; the name is kept so that a
reader finds the counterpart).

A step is traced with ``make_fx`` over fake tensors
(``analysis.graph_checks.trace``): one rank's program, with every kernel a
``repro_torch`` operator node and every collective a
``torch.distributed`` functional collective node (``_c10d_functional``:
what DTensor's gathers and reductions lower to).  From that graph:

- :func:`cost_summary`: FLOPs by ``torch.utils.flop_counter``'s formulas
  (the ones ``FlopCounterMode`` applies), with formulas registered for the
  kernel operators that count their work from their shapes as the chip
  script's bounds do; bytes as each op's inputs read once and outputs
  written once (views move nothing);
- :func:`memory_summary`: the rank's parameter, optimizer, batch and cache
  bytes, and the activation peak of the traced step (a liveness scan over
  the graph);
- :func:`collective_stats`: per-rank traffic of the collectives the step
  issues, with the reference's ring discounts (all-gather / reduce-scatter
  (g-1)/g of the result, all-reduce 2(g-1)/g, all-to-all (g-1)/g);
- :func:`roofline_terms`: the reference's formula and return dict, its
  constants the H100's.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

from ..analysis.graph_checks import node_val, op_name
from ..kernels._library import kernel_of
from ..tree import tree_items

# ---------------------------------------------------------------------------
# The card's peaks: NVIDIA H100 80GB HBM3, SXM, at its 700 W power limit
# (NVIDIA's data sheet, dense rates)
# ---------------------------------------------------------------------------

#: H100 80GB HBM3 SXM (700 W): dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: H100 80GB HBM3 SXM (700 W): HBM3 bytes/s
HBM_BW = 3.35e12
#: H100 80GB HBM3 SXM (700 W): NVLink 4 bytes/s per direction
LINK_BW = 450e9

#: ops that alias their input: no bytes moved
_VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "slice", "select", "squeeze", "unsqueeze", "detach",
    "alias", "as_strided", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "diagonal", "view_as", "unflatten", "flatten", "movedim",
    "_reshape_alias", "lift_fresh", "lift_fresh_copy",
})
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", lambda g: (g - 1) / g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda g: (g - 1) / g),
    "all_reduce": ("all-reduce", lambda g: 2 * (g - 1) / g),
    "all_to_all_single": ("all-to-all", lambda g: (g - 1) / g),
    "broadcast": ("collective-permute", lambda g: 1.0),
}


# ---------------------------------------------------------------------------
# The kernels' operations, counted from their shapes
# ---------------------------------------------------------------------------

def _qmm_flops(x, q, s_wl, s_wr, out_shape=None, **kw) -> int:
    return 2 * x[0] * x[1] * out_shape[1]


def _decode_flops(q, k, v, lengths, k_scale=None, v_scale=None,
                  out_shape=None, **kw) -> int:
    S, Hkv, G, hd = q
    return 4 * S * Hkv * G * k[1] * hd          # every row of the view


def _decode_paged_flops(q, pool_k, pool_v, pt, lengths, k_scale, v_scale,
                        out_shape=None, **kw) -> int:
    S, Hkv, G, hd = q
    return 4 * S * Hkv * G * pt[1] * pool_k[1] * hd


def _flash_flops(q, k, v, causal, layout, out_shape=None, **kw) -> int:
    B, S, H, hd = q
    full = 4 * B * H * S * k[1] * hd
    return full // 2 if causal else full


def _fq_fwd_flops(x, s, bits, out_shape=None, **kw) -> int:
    return 4 * x[0] * x[1]


def _fq_bwd_flops(g, x, s, bits, rule, out_shape=None, **kw) -> int:
    return 8 * x[0] * x[1]


def _ffq_fwd_flops(w, s_wl, s_wr, bits, out_dtype, out_shape=None,
                   **kw) -> int:
    """The factored forward: the scale's product, then fake_quant's 4."""
    return 5 * w[0] * w[1]


def _ffq_bwd_flops(gy, w, s_wl, s_wr, bits, out_shape=None, **kw) -> int:
    """The factored backward: the scale's product, the "ste" gradient's
    8, and each factor's product and sum (4; 1 without S_wL)."""
    return (9 + (4 if s_wl is not None else 1)) * w[0] * w[1]


def _register() -> None:
    ops = torch.ops.repro_torch
    for op, fn in ((ops.quant_matmul, _qmm_flops),
                   (ops.quant_matmul_dequant, _qmm_flops),
                   (ops.quant_matmul_i8, _qmm_flops),
                   (ops.decode_attention, _decode_flops),
                   (ops.decode_attention_paged, _decode_paged_flops),
                   (ops.flash_attention, _flash_flops),
                   (ops.fake_quant_fwd, _fq_fwd_flops),
                   (ops.fake_quant_bwd, _fq_bwd_flops),
                   (ops.fake_quant_factored_fwd, _ffq_fwd_flops),
                   (ops.fake_quant_factored_bwd, _ffq_bwd_flops)):
        register_flop_formula(op)(fn)


_register()


# ---------------------------------------------------------------------------
# graph walks
# ---------------------------------------------------------------------------

def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _as_vals(a):
    if isinstance(a, torch.fx.Node):
        return node_val(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_as_vals(x) for x in a)
    return a


def node_flops(node) -> int:
    """FLOPs of one graph node by the flop counter's formula for its op (0
    for an op it has none for: element-wise work and data movement)."""
    packet = getattr(node.target, "overloadpacket", None)
    fn = flop_registry.get(packet)
    if fn is None:
        return 0
    args = [_as_vals(a) for a in node.args]
    kwargs = {k: _as_vals(v) for k, v in node.kwargs.items()}
    return int(fn(*args, **kwargs, out_val=node_val(node)))


def cost_summary(tr) -> dict[str, Any]:
    """``{"flops", "bytes", "kernel_flops"}`` of one traced step (per rank):
    FLOPs by the flop counter's formulas (the kernels' by their shapes),
    bytes as every non-view op's inputs read once and outputs written once;
    ``kernel_flops`` the kernels' share, by kernel."""
    flops = nbytes = 0
    kernels: dict[str, int] = {}
    for node in tr.nodes():
        f = node_flops(node)
        flops += f
        k = kernel_of(node.target)
        if k:
            kernels[k] = kernels.get(k, 0) + f
        if op_name(node) in _VIEWS or op_name(node) == "getitem":
            continue
        seen = set()
        for a in node.all_input_nodes:
            if a not in seen:
                seen.add(a)
                nbytes += _nbytes(node_val(a))
        nbytes += _nbytes(node_val(node))
    return {"flops": float(flops), "bytes": float(nbytes),
            "kernel_flops": {k: float(v) for k, v in sorted(kernels.items())}}


def tree_bytes(tree) -> int:
    """Bytes a rank holds of ``tree``: a DTensor leaf's local shard."""
    n = 0
    for _, t in tree_items(tree):
        if hasattr(t, "to_local"):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def activation_peak(tr) -> int:
    """The largest sum of live intermediate values over the graph's order:
    each non-view node's output lives from its definition to its last use
    (inputs and constants excluded: they are the state)."""
    order = {n: i for i, n in enumerate(tr.graph.nodes)} if tr.graph else {}
    last: dict = {}
    for n in order:
        for a in n.all_input_nodes:
            last[a] = max(last.get(a, -1), order[n])
    frees: dict[int, int] = {}
    live = peak = 0
    for n, i in order.items():
        if n.op == "call_function" and op_name(n) not in _VIEWS \
                and op_name(n) != "getitem":
            b = _nbytes(node_val(n))
            live += b
            end = last.get(n, i)
            frees[end] = frees.get(end, 0) + b
        peak = max(peak, live)
        live -= frees.pop(i, 0)
    return peak


def memory_summary(param_bytes: float, optimizer_bytes: float, batch,
                   cache, activation_peak_bytes: float) -> dict[str, float]:
    """A rank's bytes: its shards of the parameters (student and teacher,
    or the deployed artifact's view) and of the optimizer state, its rows
    of the batch and their cache (trees), and the step's activation peak
    (:func:`activation_peak`); ``peak_bytes`` their sum."""
    out = {"param_bytes": float(param_bytes),
           "optimizer_bytes": float(optimizer_bytes),
           "batch_bytes": float(tree_bytes(batch or {})),
           "cache_bytes": float(tree_bytes(cache or {})),
           "activation_peak_bytes": float(activation_peak_bytes)}
    out["peak_bytes"] = sum(out.values())
    return out


def _group_size(node, n_devices: int) -> int:
    """The size of the group a collective node runs over: its group name
    is its last string argument (an all-reduce's first is its reduce
    op)."""
    names = [a for a in node.args if isinstance(a, str)]
    if names:
        try:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(names[-1]).size()
        except (RuntimeError, ValueError, KeyError):
            pass
    return n_devices


def _group_ranks(name: str) -> tuple | None:
    try:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return tuple(dist.get_process_group_ranks(
            _resolve_process_group(name)))
    except (RuntimeError, ValueError, KeyError):
        return None


def mesh_axes(mesh) -> dict:
    """This rank's group of each axis of ``mesh``, as its ranks → the
    axis name: what :func:`collective_stats` names a collective's group
    by (a mesh made again over the same ranks has new group names)."""
    import torch.distributed as dist
    return {tuple(dist.get_process_group_ranks(mesh.get_group(a))): a
            for a in mesh.mesh_dim_names}


def collective_stats(tr, n_devices: int,
                     axes: dict | None = None) -> dict[str, Any]:
    """Per-rank collective traffic in bytes (the reference's ring model),
    from the graph's functional collectives; with ``axes``
    (:func:`mesh_axes`) also ``per_axis``, the traffic by
    ``"<kind>/<axis>"`` (a group that is no mesh axis's by its size,
    ``size<g>``)."""
    per_kind: dict[str, float] = {}
    per_axis: dict[str, float] = {}
    total = 0.0
    ops = 0
    for node in tr.nodes():
        if getattr(node.target, "namespace", "") != "_c10d_functional":
            continue
        hit = _COLLECTIVES.get(op_name(node))
        if hit is None:
            continue
        kind, ring = hit
        g = _group_size(node, n_devices)
        traffic = _nbytes(node_val(node)) * ring(g) if g > 1 else 0.0
        per_kind[kind] = per_kind.get(kind, 0.0) + traffic
        if axes is not None:
            names = [a for a in node.args if isinstance(a, str)]
            axis = axes.get(_group_ranks(names[-1])) if names else None
            key = f"{kind}/{axis or f'size{g}'}"
            per_axis[key] = per_axis.get(key, 0.0) + traffic
        total += traffic
        ops += 1
    out = {"collective_bytes": total, "per_kind": per_kind, "n_ops": ops}
    if axes is not None:
        out["per_axis"] = per_axis
    return out


def roofline_terms(flops_dev: float, bytes_dev: float, coll_dev: float,
                   model_flops_total: float, n_chips: int,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict[str, Any]:
    """The reference's roofline terms; the constants default to the H100
    80GB HBM3 SXM at 700 W (989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450
    GB/s NVLink per direction)."""
    t_c = flops_dev / peak_flops
    t_m = bytes_dev / hbm_bw
    t_x = coll_dev / link_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])
    t_bound = max(t_c, t_m, t_x, 1e-12)
    useful = model_flops_total / max(flops_dev * n_chips, 1.0)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom[0],
        "roofline_fraction": t_c / t_bound,   # fraction of bound spent computing
        "model_flops": model_flops_total,
        "useful_flops_ratio": useful,
    }
