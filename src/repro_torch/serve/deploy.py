"""Deployment export: freeze the offline subgraph into serving constants.

``export_for_layers`` walks the student tree (one stacked layer at a time;
``export_model`` in one walk), runs each linear's offline subgraph once
(quantize → int4-pack) and drops the FP masters, streams and DoF.  ``deploy_view`` turns the artifact back into a forward()-compatible
tree of dequantized weights — what the JAX package's ``Engine`` serves, and
so what this one serves; ``effective_view`` is the student's fake-quant
weights in the same structure, the oracle the export is held against.
Per-tensor decisions come from the resolved
:class:`~repro_torch.core.plan.QuantPlan` carried by the
:class:`DeployPlan`; the artifact embeds the plan as a uint8 leaf.

Stacked layer tensors are exported and dequantized one layer at a time, so
a full-width model never holds more than one layer's f32 temporaries.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from ..core import dof
from ..core.fakequant import fake_quant, quantize
from ..core.plan import (PLAN_KEY, STREAM_KEYS, STREAM_OF, QuantPlan,
                         _is_qlinear, plan_from_array, plan_to_array,
                         resolve_plan)
from ..core.qconfig import QLayout, QuantConfig
from ..device import resolve_device
from ..kernels.ops import kernel_tiles_ok, qlinear_deployed
from ..kernels.quant_matmul import quant_matmul
from ..models import init_cache
from ..models.transformer import layer_slice, stack_depth
from .kv_cache import PAGED_KV_FAMILIES, KVSpec

Params = dict[str, Any]

#: the layer-stacked subtrees, exported and dequantized one leading index
#: at a time (the hybrid's ``layers`` is ``[G, attn_every, ...]``: a group
#: at a time; the encoder-decoder's ``enc_layers``/``dec_layers`` a layer)
_STACKED = ("layers", "enc_layers", "dec_layers", "tail")


# Deprecation shim only: the bare-name exemption set artifacts exported
# before QuantPlan were frozen under.  New code never reads this — the
# resolved plan is the single source of per-tensor bits.
_LEGACY_EXEMPT_8B = frozenset({"router", "lm_head", "fc"})


def _warn_legacy(what: str) -> None:
    warnings.warn(
        f"DeployPlan has no resolved QuantPlan; falling back to the legacy "
        f"bare-name heuristic for {what}. Re-export the artifact (new "
        f"exports embed the plan) or pass params= to make_deploy_plan.",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class DeployPlan:
    """Static deployment decisions, fixed at export time.

    Per-tensor truth lives in ``quant_plan``.  Without one (an artifact
    exported before plans were embedded) ``bits_for``/``is_packed`` fall
    back, with a ``DeprecationWarning``, to the legacy bare-name heuristic
    and the global ``packed`` default.  ``use_kernels`` routes the decode
    attention and ``qlinear_deployed`` through the CUDA kernels; it is on
    by default, and ``False`` is the plain route on the card.
    """
    qcfg: QuantConfig
    arch: str = ""
    family: str = "dense"
    packed: bool = True               # legacy global default (shim path only)
    use_kernels: bool = True
    layout: QLayout | None = None
    quant_plan: QuantPlan | None = None

    def spec_for(self, path: str):
        return None if self.quant_plan is None else self.quant_plan.get(path)

    def bits_for(self, path: str) -> int:
        if self.quant_plan is not None:
            return self.quant_plan.bits_for(path)
        _warn_legacy(f"bits_for({path!r})")
        name = path.rsplit(".", 1)[-1]
        return (self.qcfg.exempt_bits if name in _LEGACY_EXEMPT_8B
                else self.qcfg.w_bits)

    def is_packed(self, path: str) -> bool:
        if self.quant_plan is not None:
            return self.quant_plan.is_packed(path)
        return self.packed and self.bits_for(path) == 4


def make_deploy_plan(qcfg: QuantConfig, arch: str = "", family: str = "dense",
                     use_kernels: bool = True,
                     quant_plan: QuantPlan | None = None, params=None,
                     model_cfg=None) -> DeployPlan:
    """Pass a resolved ``quant_plan`` or the student ``params`` to resolve
    one."""
    if quant_plan is None and params is not None:
        quant_plan = resolve_plan(qcfg, params, model_cfg=model_cfg)
    return DeployPlan(qcfg=qcfg, arch=arch, family=family,
                      packed=qcfg.w_bits == 4, use_kernels=use_kernels,
                      layout=qcfg.layout, quant_plan=quant_plan)


def plan_from_artifact(exported: Params) -> QuantPlan | None:
    """The QuantPlan embedded in an artifact, or None if it has none."""
    arr = exported.get(PLAN_KEY) if isinstance(exported, dict) else None
    return None if arr is None else plan_from_array(arr)


def _as_plan(plan_or_qcfg, params=None, artifact=None) -> DeployPlan:
    plan = (plan_or_qcfg if isinstance(plan_or_qcfg, DeployPlan)
            else make_deploy_plan(plan_or_qcfg))
    if plan.quant_plan is None and artifact is not None:
        plan = dataclasses.replace(plan,
                                   quant_plan=plan_from_artifact(artifact))
    if plan.quant_plan is None and params is not None:
        plan = dataclasses.replace(
            plan, quant_plan=resolve_plan(plan.qcfg, params))
    return plan


def init_slot_cache(cfg, max_slots: int, max_len: int,
                    dtype=torch.bfloat16, kv: KVSpec | None = None,
                    device=None) -> Params:
    """The preallocated slot-indexed serving cache.

    ``kv=None``: the monolithic cache, each ``pos`` it holds (none for the
    SSM, the shared attention's for the hybrid) made a per-slot
    ``[max_slots]`` vector.  With a :class:`KVSpec`: per-layer int8 page
    pools (plus the trash page), per-layer per-slot per-kv-head scales
    (1.0 until install fits them), the shared page table (all trash) and
    ``pos``.
    """
    if kv is not None:
        if cfg.family not in PAGED_KV_FAMILIES:
            raise ValueError(f"paged KV cache is not defined for family "
                             f"{cfg.family!r}")
        L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads_padded, cfg.head_dim
        pool = (L, kv.n_pages + 1, kv.page_size, Hkv, hd)
        return {
            "k": torch.zeros(pool, dtype=torch.int8, device=device),
            "v": torch.zeros(pool, dtype=torch.int8, device=device),
            "k_scale": torch.ones((L, max_slots, Hkv), dtype=torch.float32,
                                  device=device),
            "v_scale": torch.ones((L, max_slots, Hkv), dtype=torch.float32,
                                  device=device),
            "pt": torch.full((max_slots, kv.max_pages_per_slot),
                             kv.trash_page, dtype=torch.int32, device=device),
            "pos": torch.zeros((max_slots,), dtype=torch.int32,
                               device=device),
        }
    def slot_pos(tree):
        return {k: (torch.zeros((max_slots,), dtype=torch.int32,
                                device=device) if k == "pos"
                    else slot_pos(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    return slot_pos(init_cache(cfg, max_slots, max_len, dtype, device=device))


def init_slot_state(max_slots: int, device=None) -> Params:
    """Per-slot decode bookkeeping and sampling state, all on the device, so
    the decode loop needs one host transfer per step.  ``seed`` roots each
    slot's counter-based sampling chain (core/sampling.py); the defaults
    decode greedily."""
    S = max_slots

    def full(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=device)

    return {"cur": full(0, torch.int32),
            "done": full(True, torch.bool),
            "counts": full(0, torch.int32),
            "budget": full(0, torch.int32),
            "eos": full(-1, torch.int32),
            "seed": full(0, torch.int64),
            "temp": full(0.0, torch.float32),
            "top_k": full(0, torch.int32),
            "top_p": full(1.0, torch.float32)}


def _stream_log_sa(name: str, parent: Params):
    sname = STREAM_OF.get(name)
    stream = parent.get(sname) if sname else None
    return None if stream is None else stream["log_sa"]


def _export_node(path: tuple, node: Params, parent: Params,
                 plan: DeployPlan) -> Params:
    dotted = ".".join(path)
    return dof.export_qlinear(node, plan.qcfg,
                              log_sa_in=_stream_log_sa(path[-1], parent),
                              pack=plan.is_packed(dotted),
                              bits=plan.bits_for(dotted))


def _walk(tree, plan: DeployPlan, prefix: tuple = ()):
    if isinstance(tree, dict):
        if "w" in tree and "log_s" in tree:          # quantized embedding
            s = torch.exp(tree["log_s"])
            q = quantize(tree["w"], s, plan.qcfg.embed_bits, signed=True)
            return {"q": q.to(torch.int8), "s": s.to(torch.float32)}
        out = {}
        for k, v in tree.items():
            if k in STREAM_KEYS:
                continue                             # folded into weights
            if _is_qlinear(v):
                out[k] = _export_node(prefix + (k,), v, tree, plan)
            else:
                out[k] = _walk(v, plan, prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, plan, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return tree


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def to_device(tree, dev) -> Any:
    """A tree of tensors on ``dev`` (leaves already there are not copied)."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def export_model(params: Params, plan_or_qcfg, device=None) -> Params:
    """Student params → deployment artifact on ``device`` (``None`` → the
    card), one walk over the whole tree with no layer stacking: the JAX
    package's unstacked export.  The serialized QuantPlan rides along under
    ``PLAN_KEY`` when the plan has one."""
    dev = resolve_device(device)
    plan = _as_plan(plan_or_qcfg, params=params)
    out = _walk(to_device(params, dev), plan)
    if plan.quant_plan is not None:
        out[PLAN_KEY] = plan_to_array(plan.quant_plan, device=dev)
    return out


def export_for_layers(params: Params, plan_or_qcfg, device=None) -> Params:
    """Student params → deployment artifact on ``device`` (``None`` → the
    card), with the serialized QuantPlan under ``PLAN_KEY``.  Stacked layers
    are exported one at a time."""
    dev = resolve_device(device)
    plan = _as_plan(plan_or_qcfg, params=params)
    out = {}
    for k, v in params.items():
        if k in _STACKED:
            out[k] = _stack([_walk(to_device(layer_slice(v, i), dev), plan,
                                   (k,)) for i in range(stack_depth(v))])
        elif k in STREAM_KEYS:
            continue
        elif _is_qlinear(v):
            streams = {s: to_device(params[s], dev)
                       for s in STREAM_KEYS & params.keys()}
            out[k] = _export_node((k,), to_device(v, dev), streams, plan)
        else:
            out[k] = _walk(to_device(v, dev), plan, (k,))
    if plan.quant_plan is not None:
        out[PLAN_KEY] = plan_to_array(plan.quant_plan, device=dev)
    return out


def _dequant(ex: Params, dtype, stacked: bool) -> torch.Tensor:
    """dequantize_export, one layer at a time when ``stacked`` (the layer
    axis only: an expert stack's ``s_wl`` is shared by its experts and
    broadcasts over them in ``dequantize_export``)."""
    packed = ex["q"].dtype == torch.uint8
    if not stacked:
        return dof.dequantize_export(ex, dtype, packed=packed)
    return torch.stack([dof.dequantize_export(layer_slice(ex, i), dtype,
                                              packed=packed)
                        for i in range(ex["q"].shape[0])])


def deploy_view(exported: Params, plan_or_qcfg,
                dtype=torch.bfloat16) -> Params:
    """Artifact → forward()-compatible tree of dequantized weights (use
    with ``qcfg=None`` in forward), on the artifact's device."""
    _as_plan(plan_or_qcfg, artifact=exported)

    def walk(tree, stacked: bool):
        if isinstance(tree, dict):
            if "q" in tree and "s" in tree:          # embedding
                return {"w": tree["q"].to(torch.float32) * tree["s"]}
            if "q" in tree and "s_wr" in tree:
                out: Params = {"w": _dequant(tree, dtype, stacked)}
                if "b" in tree:
                    out["b"] = tree["b"]
                return out
            return {k: walk(v, stacked or k in _STACKED)
                    for k, v in tree.items() if k != PLAN_KEY}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, stacked) for v in tree)
        return tree

    return walk(exported, False)


def _effective_node(path: tuple, node: Params, parent: Params,
                    plan: DeployPlan, dtype) -> Params:
    out: Params = {"w": dof.effective_weight(
        node, plan.qcfg, _stream_log_sa(path[-1], parent),
        compute_dtype=dtype, bits=plan.bits_for(".".join(path)))}
    if "b" in node:
        out["b"] = node["b"]
    return out


@torch.no_grad()
def effective_view(params: Params, plan_or_qcfg,
                   dtype=torch.float32) -> Params:
    """Fake-quant (training-time) weights in :func:`deploy_view`'s tree
    structure, through the plain composition, one stacked layer at a time.

    The oracle for export fidelity: ``deploy_view(export_for_layers(p))``
    must match ``effective_view(p)`` leaf for leaf up to float tolerance.
    """
    plan = _as_plan(plan_or_qcfg, params=params)
    qcfg = plan.qcfg

    def walk(tree, prefix: tuple):
        if isinstance(tree, dict):
            if "w" in tree and "log_s" in tree:      # quantized embedding
                s = torch.exp(tree["log_s"])
                return {"w": fake_quant(tree["w"], s, qcfg.embed_bits,
                                        signed=True).to(torch.float32)}
            out = {}
            for k, v in tree.items():
                if k in STREAM_KEYS:
                    continue
                if _is_qlinear(v):
                    out[k] = _effective_node(prefix + (k,), v, tree, plan,
                                             dtype)
                else:
                    out[k] = walk(v, prefix + (k,))
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        return tree

    out = {}
    for k, v in params.items():
        if k in _STACKED:
            out[k] = _stack([walk(layer_slice(v, i), (k,))
                             for i in range(stack_depth(v))])
        elif k in STREAM_KEYS:
            continue
        elif _is_qlinear(v):
            out[k] = _effective_node((k,), v, params, plan, dtype)
        else:
            out[k] = walk(v, (k,))
    return out


def abstract_deploy_surfaces(cfg, qcfg: QuantConfig,
                             use_kernels: bool = True):
    """The whole init → export → deploy_view chain on the meta device
    (shapes only, nothing allocated; any size) for the static analyzer.

    Returns ``(plan, exported, deployed)``: ``plan`` is the DeployPlan
    with a QuantPlan resolved over the shape-only init tree, the same
    resolution the Engine's constructor makes over real parameters.
    """
    from ..models import init_model
    params = init_model(0, cfg, qcfg, device="meta")
    plan = make_deploy_plan(qcfg, arch=getattr(cfg, "name", ""),
                            family=cfg.family, use_kernels=use_kernels,
                            params=params, model_cfg=cfg)
    with torch.no_grad():
        exported = export_for_layers(params, plan, device="meta")
        deployed = deploy_view(exported, plan)
    return plan, exported, deployed


def find_exported_linears(tree, prefix: tuple = ()) -> list[tuple]:
    """Paths of every exported linear ({q, s_wr} with a matmul-shaped q)."""
    out: list[tuple] = []
    if isinstance(tree, dict):
        if "q" in tree and "s_wr" in tree:
            if tree["s_wr"].ndim >= tree["q"].ndim - 2:
                out.append(prefix)
            return out
        for k, v in tree.items():
            if k == PLAN_KEY:
                continue
            out.extend(find_exported_linears(v, prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(find_exported_linears(v, prefix + (i,)))
    return out


def kernel_route_check(exported: Params, plan: DeployPlan) -> dict | None:
    """Drive ONE exported linear through ``kernels.ops.qlinear_deployed``
    under the plan and compare with the dequantized f32 matmul.

    Returns ``{path, layout, kernel, max_err}``; ``kernel`` says whether the
    CUDA ``quant_matmul`` kernel actually launched (read off its launch
    count), so the check cannot report parity that never ran the kernel.
    Prefers, in walk order, a linear whose packed shape both the kernel and
    the JAX package's Pallas blocks tile (so both packages probe the same
    linear: mamba2's ``in_proj``, N 8512, tiles by the kernel's 64 but not
    by the Pallas 128), then one the kernel tiles.  None if the artifact
    has no matmul-shaped linear.
    """
    paths = find_exported_linears(exported)
    if not paths:
        return None
    M = 4                                     # probe batch rows

    def leaf(path):
        ex = exported
        for k in path:
            ex = ex[k]
        return ex

    def unstack(ex):
        while ex["q"].ndim > 2:
            ex = layer_slice(ex, 0)
        return ex

    def reaches_kernel(ex):
        if ex["q"].dtype != torch.uint8:
            return False
        n_groups = ex["s_wr"].shape[0] if ex["s_wr"].ndim == 2 else None
        return kernel_tiles_ok(M, ex["q"].shape[-1], ex["q"].shape[-2] * 2,
                               n_groups)

    def pallas_tiles(ex):
        """The JAX package's ``pallas_tiles_ok`` (blocks 128 x 128 x 256,
        each clamped to its dim)."""
        N, K = ex["q"].shape[-1], ex["q"].shape[-2] * 2
        bn, bk = min(128, N), min(256, K)
        if N % bn or K % bk:
            return False
        if ex["s_wr"].ndim != 2:
            return True
        n_groups = ex["s_wr"].shape[0]
        return K % n_groups == 0 and bk % (K // n_groups) == 0

    cands = [(path, unstack(leaf(path))) for path in paths]
    path, ex = next(
        (c for c in cands if reaches_kernel(c[1]) and pallas_tiles(c[1])),
        next((c for c in cands if reaches_kernel(c[1])), cands[0]))
    dotted = ".".join(str(p) for p in path)
    spec = plan.spec_for(dotted)
    w = dof.dequantize_export(ex, torch.float32,
                              packed=ex["q"].dtype == torch.uint8)
    gen = torch.Generator(device=w.device).manual_seed(0)
    x = torch.randn((M, w.shape[0]), generator=gen, device=w.device)
    before = quant_matmul.launches
    y = qlinear_deployed(x, ex, plan=plan)
    launched = quant_matmul.launches > before
    y_ref = x @ w
    if "b" in ex:
        y_ref = y_ref + ex["b"]
    layout = spec.layout if spec is not None else str(
        plan.layout if plan.layout is not None else plan.qcfg.layout)
    return {"path": dotted, "layout": layout, "kernel": launched,
            "max_err": float(torch.max(torch.abs(y - y_ref)))}
