"""Quantization-aware transformer: init, caches and the forward.

Teacher (``qcfg=None``) and student run the same code.  Layer parameters
stay stacked on a leading axis, as the JAX package's ``vmap``-stacked trees
are, so converted trees and exports line up; the ``lax.scan`` over layers is
a loop over that axis.  The dense GQA and MoE families are ported.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from ..device import resolve_device
from ..tree import tree_from_items, tree_items
from .attention import attention, init_attention, init_kv_cache
from .config import ModelConfig
from .layers import (embed_lookup, init_embed, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, tap)
from .moe import init_moe, moe_block

Params = dict[str, Any]

#: the families this module runs
FAMILIES = ("dense", "moe")

_RUNTIME: dict[str, Any] = {}


def set_runtime(**kw) -> None:
    """Process-level runtime knobs: ``moe_mode`` (``"sorted"``, the
    default, or ``"dense"``, the oracle)."""
    _RUNTIME.update(kw)


def _require_family(cfg: ModelConfig) -> None:
    if (cfg.family not in FAMILIES or cfg.mlp != "swiglu"
            or cfg.mrope_sections or cfg.mla or cfg.ssm
            or (cfg.moe is None) != (cfg.family == "dense")):
        raise NotImplementedError(
            f"repro_torch ports the dense GQA and MoE families (SwiGLU, "
            f"RoPE); {cfg.name!r} is family {cfg.family!r}")


def _sorted(tree):
    return ({k: _sorted(tree[k]) for k in sorted(tree)}
            if isinstance(tree, dict) else tree)


def _init_attn_layers(gen: torch.Generator, cfg: ModelConfig,
                      qcfg: QuantConfig | None, n: int) -> Params:
    lead = (n,)
    layers = {"norm1": init_rmsnorm(cfg.d_model, lead, gen.device),
              "norm2": init_rmsnorm(cfg.d_model, lead, gen.device),
              "attn": init_attention(gen, cfg, qcfg, lead=lead),
              "mlp": (init_moe(gen, cfg, qcfg, lead=lead)
                      if cfg.moe is not None
                      else init_mlp(gen, cfg.d_model, cfg.d_ff, qcfg,
                                    bias=False, lead=lead))}
    # the JAX package's vmap-stacked layer tree comes back with sorted keys;
    # keeping that order keeps plan JSON and artifact walk order identical
    return _sorted(layers)


class _ShapeOnly:
    """Stands in for a generator on the meta device: the init code reads
    its ``device`` and draws nothing."""
    device = torch.device("meta")


def init_model(gen: torch.Generator | int, cfg: ModelConfig,
               qcfg: QuantConfig | None, device=None) -> Params:
    """Random parameters from ``gen`` (or a seed) on ``device`` (``None`` →
    the card; ``"meta"`` → a skeleton of shapes, nothing allocated, the
    seed unused).  Key order follows the JAX package, so the resolved
    plan's JSON is the same for a converted tree and for one built here."""
    _require_family(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _ShapeOnly()
    elif isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} but device {dev}")
    V, d = cfg.vocab_padded, cfg.d_model
    params: Params = {"final_norm": init_rmsnorm(d, device=dev),
                      "embed": init_embed(gen, V, d, qcfg)}
    if not cfg.tie_embeddings:       # a tied head reads the embedding table
        params["lm_head"] = dof.init_qlinear(
            gen, d, V, qcfg, name="lm_head",
            w_bits=None if qcfg is None else qcfg.embed_bits)
    if qcfg is not None:
        params["head_stream"] = dof.init_stream(d, device=dev)
    params["layers"] = _init_attn_layers(gen, cfg, qcfg, cfg.n_layers)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype,
                         device=device)


def stack_depth(tree) -> int:
    """Length of the leading (layer) axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree) -> list:
    """Every layer of a stacked tree, as views from one ``unbind`` per leaf.
    Its backward stacks the layers' gradients once; indexing each layer
    (``layer_slice``) would add a zero-filled full-depth gradient per
    layer, quadratic in depth."""
    items = list(tree_items(tree))
    cols = [torch.unbind(t) for _, t in items]
    return [tree_from_items((path, col[i]) for (path, _), col
                            in zip(items, cols))
            for i in range(stack_depth(tree))]


def _attn_block(x, lp, cfg, qcfg, positions, cache, pv, use_kernels, taps,
                prefix):
    h = rmsnorm(x, lp["norm1"])
    tap(taps, prefix + ".attn_in", h)
    a = attention(h, lp["attn"], cfg, qcfg, positions, cache,
                  plan=pv.child("attn"), use_kernels=use_kernels, taps=taps,
                  prefix=prefix + ".attn")
    tap(taps, prefix + ".attn_out", a)
    x = x + a
    h = rmsnorm(x, lp["norm2"])
    tap(taps, prefix + ".mlp_in", h)
    if cfg.moe is not None:           # taps no mlp.act, as the JAX package
        m = moe_block(h, lp["mlp"], cfg, qcfg,
                      mode=_RUNTIME.get("moe_mode", "sorted"),
                      plan=pv.child("mlp"), use_kernels=use_kernels)
    else:
        m = mlp(h, lp["mlp"], qcfg, plan=pv.child("mlp"), taps=taps,
                prefix=prefix + ".mlp", use_kernels=use_kernels)
    tap(taps, prefix + ".mlp_out", m)
    return x + m


def forward(params: Params, cfg: ModelConfig, qcfg: QuantConfig | None,
            batch: dict[str, torch.Tensor], cache: Params | None = None,
            compute_dtype=torch.bfloat16, plan=None,
            use_kernels: bool = False, collect_taps: bool = False,
            logits: bool = True) -> dict[str, Any]:
    """Returns {hidden, logits, cache, taps}.

    cache=None → full sequence (train / eval); a cache → prefill (S > 1) or
    decode (S == 1), writing K/V into it in place and advancing its
    ``pos``.  ``plan`` makes the fake-quant forward plan-aware (per-path
    bits); ``use_kernels`` routes the per-slot decode attention
    (``models.attention.decode_route``), the cache-free attention of a
    full-precision model's no-gradient forward
    (``models.attention.prefill_route``) and the
    weights' fake-quant (``core.dof.weight_fake_quant``) through the
    kernels.
    ``collect_taps`` records per-channel ``{min, max, mean}`` at every
    stream point as ``L{i}.attn_in`` … (the JAX package's tap names);
    ``logits=False`` skips the head (``logits`` is then None), as XLA drops
    it from a step whose loss reads only the hidden states.
    """
    _require_family(cfg)
    pv = plan_view(plan)
    taps: dict | None = {} if collect_taps else None
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], qcfg, compute_dtype,
                     use_kernels=use_kernels)
    base = 0 if cache is None else cache["pos"]
    ar = torch.arange(S, device=tokens.device)
    if isinstance(base, torch.Tensor) and base.ndim == 1:
        positions = base[:, None] + ar[None, :]
    else:
        positions = torch.broadcast_to(base + ar[None, :], (B, S))
    layers = params["layers"]
    lpv = pv.child("layers")
    shared = {} if cache is None else {
        k: cache[k] for k in ("pos", "pt") if k in cache}
    for i, lp in enumerate(unstack(layers)):
        c = None if cache is None else {
            **{k: v[i] for k, v in cache.items() if k not in ("pos", "pt")},
            **shared}
        x = _attn_block(x, lp, cfg, qcfg, positions, c, lpv, use_kernels,
                        taps, f"L{i}")
    if cache is not None:
        cache["pos"] = cache["pos"] + S
    h = rmsnorm(x, params["final_norm"])
    out = None
    if logits and cfg.tie_embeddings:
        # the stored table (the student's FP master, the deploy view's
        # dequantized rows), unquantized, as the JAX package's tied head
        out = h @ params["embed"]["w"].to(h.dtype).T
    elif logits:
        out = dof.qlinear(h, params["lm_head"], qcfg,
                          stream=params.get("head_stream"),
                          bits=None if qcfg is None
                          else pv.bits("lm_head", qcfg.embed_bits),
                          use_kernels=use_kernels)
    return {"hidden": h, "logits": out, "cache": cache, "taps": taps}
