"""Quantization-aware transformer: init, caches and the forward.

Teacher (``qcfg=None``) and student run the same code.  Layer parameters
stay stacked on a leading axis, as the JAX package's ``vmap``-stacked trees
are, so converted trees and exports line up; the ``lax.scan`` over layers is
a loop over that axis.  Every family of the JAX package is ported: dense
GQA, MoE, MLA + MoE (DeepSeek-V2), the Mamba2 SSM, the Zamba2 hybrid, the
VLM backbone (Qwen2-VL: patch embeddings stubbed, M-RoPE positions) and
the encoder-decoder (SeamlessM4T: the audio frontend stubbed to frame
embeddings, stacked ``enc_layers``/``dec_layers``, cross attention).  The
hybrid's Mamba2 layers are stacked ``[G, attn_every]`` (each group followed
by the one shared attention block), its remainder ``[r]`` under ``tail``.

Remat (the JAX package's ``_maybe_remat``): with ``cfg.remat`` and
``cfg.scan_layers`` each layer body — the hybrid's whole group of Mamba2
layers and its shared-attention call — runs under
``torch.utils.checkpoint`` (non-reentrant) wherever a gradient is taken, so
only the layer boundaries are kept and the backward recomputes the rest.
``remat_policy`` ``"full"`` recomputes everything; ``"save_dots"`` keeps
the outputs of the products with no batch dimension (``aten.mm``/
``aten.addmm``: the linears) as ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable`` does, and recomputes batched products
(attention, the expert stacks) and elementwise work; ``"none"`` keeps
everything.  A recompute runs the weights' fake-quant forward again.

A DTensor leaf (``launch.train``'s sharded step stores the student and the
teacher so, the dry-run's inference cells the exported artifact) is taken
where it is used, as ``sharding.tp`` views it: a layer's leaves at the
start of that layer's body, inside the remat region (so under remat only
one layer's weights live at a time, and the backward takes them again),
the embedding, head and final norms at the start of the forward.  On a
mesh whose ``model`` axis has more than one rank, the dense attention and
the dense MLP of a stacked layer run on the rank's shards — columns, rows
and heads, with *f*/*g* over ``model`` — and the embedding on its
vocabulary rows (``sharding.tp.layer_view``, ``embed_view``); an exported
layer is dequantized there, each rank its own shard, and on it MLA runs
on the rank's heads and the MoE block on its experts and shared experts'
columns and rows.  Every other leaf is gathered whole: in the train step
the MoE experts and MLA; everywhere Mamba2, the hybrid's shared block, the
encoder-decoder's layers, the norms, and in a cache-free forward the
head.  A forward with a cache (prefill and decode: the dry-run's
inference cells) takes its DTensor cache leaves as the rank's local
shards (``sharding.tp.cache_view``): the dense attention writes and reads
the k/v as they are split over ``model`` (by KV heads, by the sequence,
or whole on every rank; ``models.attention``), MLA its latent
``ckv``/``kr`` (by the sequence, or whole), and the head is
vocabulary-parallel, so the logits are the rank's slice of the
vocabulary.  Each view states how its gradient relates to the model
group's (``sharding.tp``'s rule).  The batch itself is split over the
``dp`` axes before the forward (``launch.train.local_rows``); a cache
holds those rows, and a per-slot ``pos`` is theirs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
# torch.utils.checkpoint imports torch._dynamo at its first call; an import
# inside a forward leaves that forward's frames (and the tensors they hold)
# referenced from the exceptions the import stores, for the whole process
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from ..device import resolve_device
from ..sharding import tp as tp_lib
from ..tree import tree_from_items, tree_items
from .attention import (attention, cross_attention, init_attention,
                        init_kv_cache, init_mla, init_mla_cache, mla_attention)
from .config import ModelConfig
from .layers import (embed_lookup, init_embed, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, tap)
from .moe import init_moe, moe_block
from .ssm import init_ssm, init_ssm_cache, ssm_block

Params = dict[str, Any]

#: the families this module runs, each with whether its config carries
#: (moe, mla, ssm)
_FAMILY_BLOCKS = {"dense": (False, False, False), "moe": (True, False, False),
                  "mla_moe": (True, True, False),
                  "ssm": (False, False, True), "hybrid": (False, False, True),
                  "vlm": (False, False, False),
                  "encdec": (False, False, False)}
FAMILIES = tuple(_FAMILY_BLOCKS)

_RUNTIME: dict[str, Any] = {}


def set_runtime(**kw) -> None:
    """Process-level runtime knobs: ``moe_mode`` (``"sorted"``, the
    default, or ``"dense"``, the oracle) and ``moe_fn`` (``fn(x, p,
    use_kernels) -> y`` or None, replacing the routed experts on the
    forward's route, e.g. ``sharding.ep.make_ep_moe``'s; None from it falls
    back to the in-graph path)."""
    _RUNTIME.update(kw)


#: the stacked layer trees, gathered one layer at a time
_STACKS = ("layers", "tail", "enc_layers", "dec_layers")


#: the products with no batch dimension (the linears): what "save_dots"
#: keeps
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_configured(cfg: ModelConfig) -> bool:
    """The JAX package's ``_maybe_remat`` condition: ``remat``,
    ``scan_layers`` and a policy other than ``"none"``."""
    return cfg.remat and cfg.scan_layers and cfg.remat_policy != "none"


def remat_on(cfg: ModelConfig) -> bool:
    """Whether layer bodies run under checkpoint: :func:`remat_configured`
    and a gradient being taken."""
    return remat_configured(cfg) and torch.is_grad_enabled()


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` itself, or ``fn`` under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy``."""
    if not remat_on(cfg):
        return fn
    if cfg.remat_policy == "save_dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: full, "
                         f"save_dots or none")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _require_family(cfg: ModelConfig) -> None:
    blocks = (cfg.moe is not None, cfg.mla is not None, cfg.ssm is not None)
    if (blocks != _FAMILY_BLOCKS.get(cfg.family)
            or cfg.mlp not in (("swiglu", "gelu") if cfg.family == "encdec"
                               else ("swiglu",))
            or (cfg.mrope_sections and cfg.family != "vlm")
            or (cfg.family == "hybrid" and cfg.attn_every < 1)):
        raise NotImplementedError(
            f"repro_torch ports the dense GQA, MoE, MLA + MoE, Mamba2 SSM, "
            f"Zamba2 hybrid, VLM (M-RoPE) and encoder-decoder (GELU MLP) "
            f"families, SwiGLU and RoPE elsewhere; {cfg.name!r} is family "
            f"{cfg.family!r}")


def _dense_view(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared attention block is a dense layer."""
    return dataclasses.replace(cfg, moe=None, mla=None)


def _sorted(tree):
    return ({k: _sorted(tree[k]) for k in sorted(tree)}
            if isinstance(tree, dict) else tree)


def _init_attn_layers(gen: torch.Generator, cfg: ModelConfig,
                      qcfg: QuantConfig | None, lead: tuple) -> Params:
    layers = {"norm1": init_rmsnorm(cfg.d_model, lead, gen.device),
              "norm2": init_rmsnorm(cfg.d_model, lead, gen.device),
              "attn": (init_mla(gen, cfg, qcfg, lead=lead)
                       if cfg.mla is not None
                       else init_attention(gen, cfg, qcfg, lead=lead)),
              "mlp": (init_moe(gen, cfg, qcfg, lead=lead)
                      if cfg.moe is not None
                      else init_mlp(gen, cfg.d_model, cfg.d_ff, qcfg,
                                    bias=False, lead=lead,
                                    mlp_type=cfg.mlp))}
    # the JAX package's vmap-stacked layer tree comes back with sorted keys;
    # keeping that order keeps plan JSON and artifact walk order identical
    return _sorted(layers)


def _init_dec_layers(gen: torch.Generator, cfg: ModelConfig,
                     qcfg: QuantConfig | None, lead: tuple) -> Params:
    """A decoder layer: the dense layer plus ``norm_x`` and ``cross``."""
    layers = _init_attn_layers(gen, cfg, qcfg, lead)
    layers["norm_x"] = init_rmsnorm(cfg.d_model, lead, gen.device)
    layers["cross"] = init_attention(gen, cfg, qcfg, lead=lead)
    return _sorted(layers)


def _init_ssm_layers(gen: torch.Generator, cfg: ModelConfig,
                     qcfg: QuantConfig | None, lead: tuple) -> Params:
    return {"norm1": init_rmsnorm(cfg.d_model, lead, gen.device),
            "ssm": init_ssm(gen, cfg, qcfg, lead=lead)}


class _ShapeOnly:
    """Stands in for a generator on the meta device: the init code reads
    its ``device`` and draws nothing."""
    device = torch.device("meta")


def init_model(gen: torch.Generator | int, cfg: ModelConfig,
               qcfg: QuantConfig | None, device=None) -> Params:
    """Random parameters from ``gen`` (or a seed) on ``device`` (``None`` →
    the card; ``"meta"`` → a skeleton of shapes, nothing allocated, the
    seed unused).  Keys are sorted at every level, as the JAX package's
    trees come back from ``jax.eval_shape`` and ``jax.device_get``, so the
    resolved plan's JSON and every walk of the tree are the same for a
    converted tree and for one built here (F23)."""
    _require_family(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _ShapeOnly()
    elif isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} but device {dev}")
    V, d = cfg.vocab_padded, cfg.d_model
    params: Params = {"final_norm": init_rmsnorm(d, device=dev)}
    if cfg.family != "encdec":      # the encoder-decoder's comes after
        params["embed"] = init_embed(gen, V, d, qcfg)
    if not cfg.tie_embeddings:       # a tied head reads the embedding table
        params["lm_head"] = dof.init_qlinear(
            gen, d, V, qcfg, name="lm_head",
            w_bits=None if qcfg is None else qcfg.embed_bits)
    if qcfg is not None:
        params["head_stream"] = dof.init_stream(d, device=dev)
    if cfg.family == "encdec":        # dense layers (no MoE, no MLA)
        params["embed"] = init_embed(gen, V, d, qcfg)       # decoder tokens
        params["frame_proj"] = dof.init_qlinear(gen, d, d, qcfg,
                                                name="frame_proj")
        params["enc_layers"] = _init_attn_layers(gen, cfg, qcfg,
                                                 (cfg.enc_layers,))
        params["dec_layers"] = _init_dec_layers(gen, cfg, qcfg,
                                                (cfg.n_layers,))
        params["enc_final_norm"] = init_rmsnorm(d, device=dev)
    elif cfg.family == "ssm":
        params["layers"] = _init_ssm_layers(gen, cfg, qcfg, (cfg.n_layers,))
    elif cfg.family == "hybrid":
        G, r = divmod(cfg.n_layers, cfg.attn_every)
        params["layers"] = _init_ssm_layers(gen, cfg, qcfg,
                                            (G, cfg.attn_every))
        if r:
            params["tail"] = _init_ssm_layers(gen, cfg, qcfg, (r,))
        params["shared_attn"] = _init_attn_layers(gen, _dense_view(cfg),
                                                  qcfg, ())
    else:
        params["layers"] = _init_attn_layers(gen, cfg, qcfg,
                                             (cfg.n_layers,))
    return _sorted(params)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               enc_len: int | None = None) -> Params:
    """The monolithic cache: the latent ``ckv``/``kr`` for MLA, the f32
    ``ssm_state``/``conv_state`` for the SSM, else ``k``/``v``.  The
    hybrid's is ``{"mamba": [G, attn_every, ...], "tail": [r, ...],
    "attn": {k, v [G, ...], pos}}``; only attention caches hold a
    ``pos``.  The encoder-decoder's is ``{"self": {k, v, pos}, "cross":
    None}``, its cross K/V filled at prefill; with ``enc_len`` the cross
    slots ``k, v [L, B, enc_len, Hkv, hd]`` exist (zeros) from the start,
    so a decode step never needs encoder frames."""
    if cfg.family == "encdec":
        cross = None
        if enc_len is not None:
            shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads_padded,
                     cfg.head_dim)
            cross = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
        return {"self": init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                      dtype, device=device),
                "cross": cross}
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, cfg.n_layers, device=device)
    if cfg.family == "hybrid":
        k = cfg.attn_every
        G, r = divmod(cfg.n_layers, k)
        c: Params = {"mamba": {
            name: t.reshape((G, k) + t.shape[1:])
            for name, t in init_ssm_cache(cfg, batch, G * k,
                                          device=device).items()}}
        if r:
            c["tail"] = init_ssm_cache(cfg, batch, r, device=device)
        c["attn"] = init_kv_cache(cfg, batch, max_len, G, dtype,
                                  device=device)
        return c
    init = init_mla_cache if cfg.mla is not None else init_kv_cache
    return init(cfg, batch, max_len, cfg.n_layers, dtype, device=device)


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
                prefix, kv=None):
    """One pre-norm attention + MLP layer; ``kv`` is how ``cache``'s k/v
    are split over ``model`` (``sharding.tp.cache_view``)."""
    lp, attn_tp, mlp_tp = tp_lib.layer_view(lp, cfg, x.dtype,
                                            cache=cache is not None, kv=kv)
    if attn_tp is not None and cache is not None:
        attn_tp = dataclasses.replace(attn_tp, kv=kv)
    elif kv is not None:
        raise ValueError(f"a cache split over model ({kv}) for an "
                         f"attention block gathered whole")
    h = rmsnorm(x, lp["norm1"])
    tap(taps, prefix + ".attn_in", h)
    if cfg.mla is not None:           # taps nothing inside, as the JAX package
        a = mla_attention(h, lp["attn"], cfg, qcfg, positions, cache,
                          plan=pv.child("attn"), use_kernels=use_kernels,
                          tp=attn_tp)
    else:
        a = attention(h, lp["attn"], cfg, qcfg, positions, cache,
                      plan=pv.child("attn"), use_kernels=use_kernels,
                      taps=taps, prefix=prefix + ".attn", tp=attn_tp)
    tap(taps, prefix + ".attn_out", a)
    x = x + a
    h = rmsnorm(x, lp["norm2"])
    tap(taps, prefix + ".mlp_in", h)
    if cfg.moe is not None:           # taps no mlp.act, as the JAX package
        m = moe_block(h, lp["mlp"], cfg, qcfg,
                      mode=_RUNTIME.get("moe_mode", "sorted"),
                      moe_fn=_RUNTIME.get("moe_fn"),
                      plan=pv.child("mlp"), use_kernels=use_kernels,
                      tp=mlp_tp)
    else:
        m = mlp(h, lp["mlp"], qcfg, plan=pv.child("mlp"), taps=taps,
                prefix=prefix + ".mlp", use_kernels=use_kernels,
                mlp_type=cfg.mlp, tp=mlp_tp)
    tap(taps, prefix + ".mlp_out", m)
    return x + m


def _ssm_layer(x, lp, cfg, qcfg, c, pv, use_kernels, taps, prefix):
    lp = tp_lib.gather(lp, x.dtype)
    h = rmsnorm(x, lp["norm1"])
    tap(taps, prefix + ".ssm_in", h)
    y = ssm_block(h, lp["ssm"], cfg, qcfg, c, taps=taps,
                  prefix=prefix + ".ssm", plan=pv.child("ssm"),
                  use_kernels=use_kernels)
    tap(taps, prefix + ".ssm_out", y)
    return x + y


def _ssm_layers(x, layers, cfg, qcfg, cache, pv, use_kernels, taps, tag,
                remat: bool = True):
    """The stacked Mamba2 layers (pre-norm, residual) in order; layer
    ``i``'s taps are named ``tag(i)``.  ``remat=False`` inside a body that
    is itself rematerialized (the hybrid's group)."""
    layer = _maybe_remat(_ssm_layer, cfg) if remat else _ssm_layer
    for i, lp in enumerate(unstack(layers)):
        c = None if cache is None else {k: v[i] for k, v in cache.items()}
        x = layer(x, lp, cfg, qcfg, c, pv, use_kernels, taps, tag(i))
    return x


def _forward_hybrid(params, x, cfg, qcfg, positions, cache, pv, use_kernels,
                    taps):
    """Each group's ``attn_every`` Mamba2 layers, then the shared attention
    block over the group's own KV; then the tail.  The tap names repeat in
    every group (``G.m{j}``, ``G.attn``; the tail's ``T{i}``), as the JAX
    package's unrolled forward writes them."""
    attn = None if cache is None else cache["attn"]
    lpv = pv.child("layers")

    def group(x, gp, shared, mc, ac):
        x = _ssm_layers(x, gp, cfg, qcfg, mc, lpv, use_kernels, taps,
                        lambda j: f"G.m{j}", remat=False)
        return _attn_block(x, shared, _dense_view(cfg), qcfg, positions, ac,
                           pv.child("shared_attn"), use_kernels, taps,
                           "G.attn")

    group = _maybe_remat(group, cfg)
    for gi, gp in enumerate(unstack(params["layers"])):
        mc = None if cache is None else {
            k: v[gi] for k, v in cache["mamba"].items()}
        ac = None if attn is None else {
            "k": attn["k"][gi], "v": attn["v"][gi], "pos": attn["pos"]}
        x = group(x, gp, params["shared_attn"], mc, ac)
    if "tail" in params:
        x = _ssm_layers(x, params["tail"], cfg, qcfg,
                        None if cache is None else cache["tail"],
                        pv.child("tail"), use_kernels, taps,
                        lambda i: f"T{i}")
    if attn is not None:
        attn["pos"] = attn["pos"] + x.shape[1]
    return x


def forward(params: Params, cfg: ModelConfig, qcfg: QuantConfig | None,
            batch: dict[str, torch.Tensor], cache: Params | None = None,
            compute_dtype=torch.bfloat16, plan=None,
            use_kernels: bool = False, collect_taps: bool = False,
            logits: bool = True) -> dict[str, Any]:
    """Returns {hidden, logits, cache, taps} (and the encoder-decoder's
    ``enc_out``).

    cache=None → full sequence (train / eval); a cache → prefill (S > 1) or
    decode (S == 1), writing K/V (and Mamba2 state) into it in place and
    advancing its ``pos``.  ``plan`` makes the fake-quant forward
    plan-aware (per-path bits); ``use_kernels`` routes the per-slot decode
    attention (``models.attention.decode_route``), the cache-free attention
    of a full-precision model's no-gradient forward
    (``models.attention.prefill_route``) and the weights' fake-quant
    (``core.dof.weight_fake_quant``) through the kernels.
    ``collect_taps`` records per-channel ``{min, max, mean}`` at every
    stream point as ``L{i}.attn_in`` … (the JAX package's tap names; the
    hybrid's ``G.m{j}.ssm_in``, ``G.attn.attn_in``, ``T{i}.ssm_in`` …;
    the encoder-decoder taps nothing, F18);
    ``logits=False`` skips the head (``logits`` is then None), as XLA drops
    it from a step whose loss reads only the hidden states.

    DTensor parameters (the sharded step's, or an exported artifact
    stored so) and a DTensor cache are computed on the rank's shards where
    the module docstring says; with a cache the logits are then the
    rank's vocabulary slice.

    The batch holds ``tokens [B, S]``, and may hold ``positions`` (``[B,
    S]``, or ``[B, 3, S]`` under M-RoPE); the VLM's ``patch_embeds [B,
    S_img, d]`` go before the token embeddings (``positions`` then covers
    ``S_img + S``); the encoder-decoder's ``frames [B, S_enc, d]`` feed the
    encoder (a cache whose ``cross`` is filled needs none).  Without
    ``positions`` they count from the cache's ``pos`` (a scalar, or one per
    slot), the three M-RoPE streams equal.
    """
    _require_family(cfg)
    store = cache
    cache, kv = tp_lib.cache_view(cache)
    params = {**params}
    viewed = set()
    # with a cache the logits are the rank's vocabulary slice
    if cache is not None or not (logits and cfg.tie_embeddings):
        params["embed"], embed_tp = tp_lib.embed_view(params["embed"],
                                                      compute_dtype)
        viewed.add("embed")
    else:
        embed_tp = None
    if cache is not None and logits and "lm_head" in params:
        params["lm_head"], _ = tp_lib.head_view(params["lm_head"],
                                                compute_dtype)
        viewed.add("lm_head")
    params = {k: v if k in _STACKS or k in viewed
              or (not logits and k in ("lm_head", "head_stream"))
              else tp_lib.gather(v, compute_dtype)
              for k, v in params.items()}
    pv = plan_view(plan)
    taps: dict | None = {} if collect_taps else None
    if cfg.family == "encdec":
        h, enc_out = _forward_encdec(params, cfg, qcfg, batch, cache, pv,
                                     use_kernels, compute_dtype, embed_tp)
        out = _head(params, cfg, qcfg, h, pv, use_kernels) if logits else None
        tp_lib.sync_cache(store, cache)
        return {"hidden": h, "logits": out, "cache": store, "taps": taps,
                "enc_out": enc_out}
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = embed_lookup(tokens, params["embed"], qcfg, compute_dtype,
                     use_kernels=use_kernels, tp=embed_tp)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(compute_dtype), x], dim=1)
    S = x.shape[1]
    base = 0
    if cache is not None and "pos" in cache:
        base = cache["pos"]
    elif cache is not None and "attn" in cache:
        base = cache["attn"]["pos"]          # hybrid: the shared-attn cache
    ar = torch.arange(S, device=tokens.device)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        if isinstance(base, torch.Tensor) and base.ndim == 1:
            positions = base[:, None] + ar[None, :]      # one per slot
        else:
            positions = torch.broadcast_to(base + ar[None, :], (B, S))
        if cfg.mrope_sections:
            positions = torch.broadcast_to(positions[:, None, :], (B, 3, S))
    if cfg.family == "ssm":
        x = _ssm_layers(x, params["layers"], cfg, qcfg, cache,
                        pv.child("layers"), use_kernels, taps,
                        lambda i: f"L{i}")
    elif cfg.family == "hybrid":
        x = _forward_hybrid(params, x, cfg, qcfg, positions, cache, pv,
                            use_kernels, taps)
    else:
        lpv = pv.child("layers")
        shared = {} if cache is None else {
            k: cache[k] for k in ("pos", "pt") if k in cache}
        block = _maybe_remat(_attn_block, cfg)
        for i, lp in enumerate(unstack(params["layers"])):
            c = None if cache is None else {
                **{k: v[i] for k, v in cache.items()
                   if k not in ("pos", "pt")}, **shared}
            x = block(x, lp, cfg, qcfg, positions, c, lpv, use_kernels, taps,
                      f"L{i}", kv)
        if cache is not None:
            cache["pos"] = cache["pos"] + S
    h = rmsnorm(x, params["final_norm"])
    out = _head(params, cfg, qcfg, h, pv, use_kernels) if logits else None
    tp_lib.sync_cache(store, cache)
    return {"hidden": h, "logits": out, "cache": store, "taps": taps}


def _head(params, cfg, qcfg, h, pv, use_kernels) -> torch.Tensor:
    if cfg.tie_embeddings:
        # the stored table (the student's FP master, the deploy view's
        # dequantized rows), unquantized, as the JAX package's tied head
        return h @ params["embed"]["w"].to(h.dtype).T
    return dof.qlinear(h, params["lm_head"], qcfg,
                       stream=params.get("head_stream"),
                       bits=None if qcfg is None
                       else pv.bits("lm_head", qcfg.embed_bits),
                       use_kernels=use_kernels)


def _forward_encdec(params, cfg, qcfg, batch, cache, pv, use_kernels,
                    compute_dtype, embed_tp=None) -> tuple[torch.Tensor, Any]:
    """The encoder over ``frames`` (skipped when the cache's cross K/V are
    filled), then the decoder: causal self-attention (RoPE), cross
    attention over the encoder output, the MLP, each pre-norm and
    residual.  Returns the decoder's final-normed hidden states and the
    encoder output (None when the encoder did not run).

    The encoder's self-attention is causal, as in the JAX package (it
    calls ``attention`` with no cache, F18).  A cache whose ``cross`` is
    None gets the cross K/V computed here, ``[L, B, S_enc, Hkv, hd]``,
    written into it (prefill); a filled one is read (decode)."""
    epv, dpv = pv.child("enc_layers"), pv.child("dec_layers")
    cross = None if cache is None else cache["cross"]
    enc_out = None
    if cross is None:
        frames = batch["frames"].to(compute_dtype)
        e = dof.qlinear(frames, params["frame_proj"], qcfg,
                        bits=pv.bits("frame_proj"), use_kernels=use_kernels)
        Be, Se = e.shape[:2]
        epos = torch.broadcast_to(
            torch.arange(Se, device=e.device)[None], (Be, Se))

        def enc_layer(e, lp):
            lp = tp_lib.gather(lp, e.dtype)
            e = e + attention(rmsnorm(e, lp["norm1"]), lp["attn"], cfg,
                              qcfg, epos, None, plan=epv.child("attn"),
                              use_kernels=use_kernels)
            return e + mlp(rmsnorm(e, lp["norm2"]), lp["mlp"], qcfg,
                           plan=epv.child("mlp"), use_kernels=use_kernels,
                           mlp_type=cfg.mlp)

        enc_layer = _maybe_remat(enc_layer, cfg)
        for lp in unstack(params["enc_layers"]):
            e = enc_layer(e, lp)
        enc_out = rmsnorm(e, params["enc_final_norm"])

    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(tokens, params["embed"], qcfg, compute_dtype,
                     use_kernels=use_kernels, tp=embed_tp)
    self_c = None if cache is None else cache["self"]
    base = 0 if self_c is None else self_c["pos"]
    positions = torch.broadcast_to(
        base + torch.arange(S, device=tokens.device)[None, :], (B, S))
    new_k, new_v = [], []

    def dec_layer(x, lp, sc, kv):
        lp = tp_lib.gather(lp, x.dtype)
        x = x + attention(rmsnorm(x, lp["norm1"]), lp["attn"], cfg, qcfg,
                          positions, sc, plan=dpv.child("attn"),
                          use_kernels=use_kernels)
        a, k, v = cross_attention(
            rmsnorm(x, lp["norm_x"]), enc_out, lp["cross"], cfg, qcfg, kv,
            plan=dpv.child("cross"), use_kernels=use_kernels)
        x = x + a
        x = x + mlp(rmsnorm(x, lp["norm2"]), lp["mlp"], qcfg,
                    plan=dpv.child("mlp"), use_kernels=use_kernels,
                    mlp_type=cfg.mlp)
        return x, k, v

    dec_layer = _maybe_remat(dec_layer, cfg)
    for i, lp in enumerate(unstack(params["dec_layers"])):
        sc = None if self_c is None else {
            "k": self_c["k"][i], "v": self_c["v"][i], "pos": self_c["pos"]}
        x, k, v = dec_layer(x, lp, sc, None if cross is None
                            else (cross["k"][i], cross["v"][i]))
        if cache is not None and cross is None:
            new_k.append(k)
            new_v.append(v)
    if cache is not None:
        if cross is None:
            cache["cross"] = {"k": torch.stack(new_k),
                              "v": torch.stack(new_v)}
        self_c["pos"] = self_c["pos"] + S
    return rmsnorm(x, params["final_norm"]), enc_out
