"""GQA attention (+qk-norm, RoPE) with monolithic and paged int8 KV caches.

Caches are dicts of tensors updated **in place** (the JAX package returns
new caches; here the slot cache is one preallocated set of tensors the
decode step writes into).  Head ``h`` of the GQA query belongs to kv-head
``h // G``, as in the JAX package.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import dof
from ..core.plan import plan_view
from ..core.qconfig import QuantConfig
from ..kernels.decode_attention import decode_attention, kernel_takes
from ..kernels.ops import attention_prefill
from ..serve.kv_cache import quantize_kv
from .config import ModelConfig
from .layers import apply_rope, init_rmsnorm, rmsnorm, tap

Params = dict[str, Any]

_NEG = -1e30


def decode_route(cfg: ModelConfig, max_len: int, use_kernels: bool) -> bool:
    """Whether the per-slot decode attention goes through
    ``kernels.decode_attention`` for a serving cache of depth ``max_len``.

    The single routing predicate: :func:`attention` applies it and
    ``serve.engine.Engine.stats()`` reports it, so they cannot disagree.
    The CUDA kernel masks a ragged last block itself, so unlike the Pallas
    kernel's ``decode_tiles_ok`` it refuses no cache depth — only head
    shapes it was not built for (``kernel_takes``)."""
    G = cfg.n_heads_padded // cfg.n_kv_heads_padded
    return (bool(use_kernels) and cfg.mla is None and max_len >= 1
            and kernel_takes(G, cfg.head_dim))


def prefill_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  use_kernels: bool) -> bool:
    """Whether the cache-free causal attention goes through
    ``kernels.ops.attention_prefill`` (the ``flash_attention`` kernel).

    Only a forward that takes no gradient on the card: the kernel has no
    backward (nor has the reference's), so the student's training forward
    stays on ``_sdpa``, and CPU tensors keep ``_sdpa`` too."""
    return (bool(use_kernels) and q.is_cuda
            and not (q.requires_grad or k.requires_grad or v.requires_grad))


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   qcfg: QuantConfig | None, lead: tuple = ()) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    p: Params = {
        "wq": dof.init_qlinear(gen, d, H * hd, qcfg, bias=cfg.bias,
                               name="wq", lead=lead),
        "wk": dof.init_qlinear(gen, d, Hkv * hd, qcfg, bias=cfg.bias,
                               name="wk", lead=lead),
        "wv": dof.init_qlinear(gen, d, Hkv * hd, qcfg, bias=cfg.bias,
                               name="wv", lead=lead),
        "wo": dof.init_qlinear(gen, H * hd, d, qcfg, bias=False, name="wo",
                               lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, lead, gen.device)
        p["k_norm"] = init_rmsnorm(hd, lead, gen.device)
    if qcfg is not None:
        p["in_stream"] = dof.init_stream(d, lead=lead, device=gen.device)
        p["out_stream"] = dof.init_stream(H * hd, lead=lead,
                                          device=gen.device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """Monolithic cache ``k``/``v`` ``[L, B, max_len, Hkv, hd]`` and a scalar
    (Python int) ``pos``."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads_padded, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset, kv_len=None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hkv,hd]; f32 logits and softmax.

    ``q_offset``/``kv_len`` are ints, or per-slot ``[B]`` tensors (serving:
    every slot at its own offset, each attending its own valid prefix)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    pos_k = torch.arange(Skv, device=q.device)
    ar_q = torch.arange(Sq, device=q.device)
    if _is_vector(q_offset):
        pos_q = q_offset[:, None] + ar_q[None, :]                 # [B, Sq]
        mask = torch.ones((B, Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (pos_q[:, :, None] >= pos_k[None, None, :])
        if kv_len is not None:
            mask = mask & (pos_k[None, None, :] < kv_len[:, None, None])
        mask = mask[:, None, None]
    else:
        pos_q = q_offset + ar_q
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (pos_q[:, None] >= pos_k[None, :])
        if kv_len is not None:
            mask = mask & (pos_k[None, :] < kv_len)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _paged_sdpa(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                lengths: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor) -> torch.Tensor:
    """Masked decode attention over gathered int8 KV pages (the plain
    route).  q: [S,1,H,hd]; k8/v8: [S,T,Hkv,hd] int8; scales [S,Hkv].  The K
    scale (and 1/sqrt(hd)) fold into q, the V scale into the context."""
    S, _, H, hd = q.shape
    T, Hkv = k8.shape[1], k8.shape[2]
    G = H // Hkv
    qg = q[:, 0].reshape(S, Hkv, G, hd)
    qs = qg * (hd ** -0.5 * k_scale)[:, :, None, None]
    logits = torch.einsum("skgh,stkh->skgt", qs, k8.to(torch.float32))
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("skgt,stkh->skgh", probs, v8.to(torch.float32))
    ctx = ctx * v_scale[:, :, None, None]
    return ctx.reshape(S, 1, H, hd)


def _paged_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache: Params, cfg: ModelConfig,
                  use_kernels: bool) -> torch.Tensor:
    """One decode step over the paged int8 KV cache (Sq == 1).

    Per-layer leaves: ``k``/``v`` int8 pools ``[n_pages+1, P, Hkv, hd]``
    (the last page is the write-sink trash page), ``k_scale``/``v_scale``
    ``[S, Hkv]``; shared ``pt [S, max_pages]`` and ``pos [S]``.  The new
    token is quantized with the slot's frozen scales and written into its
    (page, row); retired slots' page-table rows point at the trash page, so
    the unconditional every-slot write never touches a reused page.
    """
    pos, pt = cache["pos"], cache["pt"]
    pool_k, pool_v = cache["k"], cache["v"]
    ks, vs = cache["k_scale"], cache["v_scale"]
    S, n_pg = pt.shape
    P, Hkv, hd = pool_k.shape[1], pool_k.shape[2], pool_k.shape[3]
    H = q.shape[2]
    slots = torch.arange(S, device=pt.device)
    pg = pt[slots, torch.clamp(pos // P, max=n_pg - 1)]
    row = pos % P
    pool_k[pg, row] = quantize_kv(k[:, 0], ks)
    pool_v[pg, row] = quantize_kv(v[:, 0], vs)
    # each slot's pages gathered into a transient [S, T, Hkv, hd] int8 view;
    # rows past the slot's length (trash-page garbage included) are masked
    k8 = pool_k[pt].reshape(S, n_pg * P, Hkv, hd)
    v8 = pool_v[pt].reshape(S, n_pg * P, Hkv, hd)
    lengths = pos + 1
    if decode_route(cfg, n_pg * P, use_kernels):
        qd = q[:, 0].reshape(S, Hkv, H // Hkv, hd).contiguous()
        od = decode_attention(qd, k8, v8, lengths, k_scale=ks, v_scale=vs)
        return od.reshape(S, 1, H, hd)
    return _paged_sdpa(q, k8, v8, lengths, ks, vs)


def attention(x: torch.Tensor, p: Params, cfg: ModelConfig,
              qcfg: QuantConfig | None, positions: torch.Tensor,
              cache: Params | None = None, plan=None,
              use_kernels: bool = False, taps: dict | None = None,
              prefix: str = "") -> torch.Tensor:
    """GQA forward; writes this step's K/V into ``cache`` (in place) when one
    is given.  Cache modes: none (full sequence, causal); monolithic with a
    scalar ``pos`` (batch prefill); monolithic with a per-slot ``pos [B]``
    (serving decode); paged (``"pt"`` in the cache, serving decode).

    ``use_kernels`` routes the per-slot decode attention through
    ``kernels.decode_attention`` under :func:`decode_route`, the cache-free
    causal attention of a no-gradient forward through
    ``kernels.ops.attention_prefill`` under :func:`prefill_route` (``_sdpa``
    / ``_paged_sdpa`` are the plain route) and the weights' fake-quant
    through the ``fake_quant`` kernel.  ``taps`` records ``{prefix}.pre_o``."""
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    pv = plan_view(plan)
    ins = p.get("in_stream")
    q = dof.qlinear(x, p["wq"], qcfg, stream=ins, bits=pv.bits("wq"),
                    use_kernels=use_kernels).reshape(B, Sq, H, hd)
    k = dof.qlinear(x, p["wk"], qcfg, stream=ins, bits=pv.bits("wk"),
                    use_kernels=use_kernels).reshape(B, Sq, Hkv, hd)
    v = dof.qlinear(x, p["wv"], qcfg, stream=ins, bits=pv.bits("wv"),
                    use_kernels=use_kernels).reshape(B, Sq, Hkv, hd)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if prefill_route(q, k, v, use_kernels):
            out = attention_prefill(q, k, v, causal=True)
        else:
            out = _sdpa(q, k, v, causal=True, q_offset=0)
    elif "pt" in cache:
        out = _paged_decode(q, k, v, cache, cfg, use_kernels).to(x.dtype)
    else:
        pos, ck, cv = cache["pos"], cache["k"], cache["v"]
        T = ck.shape[1]
        if _is_vector(pos):
            # per-slot offsets; the start clamps so the write stays inside
            # the cache (dead slots keep advancing), as dynamic_update_slice
            start = torch.clamp(pos, 0, T - Sq)
            rows = start[:, None] + torch.arange(Sq, device=x.device)[None]
            slots = torch.arange(B, device=x.device)[:, None]
            ck[slots, rows] = k.to(ck.dtype)
            cv[slots, rows] = v.to(cv.dtype)
        else:
            # rows past the cache end can only be bucketed-prefill padding
            n = min(Sq, T - pos)
            ck[:, pos:pos + n] = k[:, :n].to(ck.dtype)
            cv[:, pos:pos + n] = v[:, :n].to(cv.dtype)
        if Sq == 1 and _is_vector(pos) and decode_route(cfg, T, use_kernels):
            qd = q[:, 0].reshape(B, Hkv, H // Hkv, hd).contiguous()
            od = decode_attention(qd, ck, cv, pos + 1)
            out = od.reshape(B, 1, H, hd).to(x.dtype)
        else:
            out = _sdpa(q, ck, cv, causal=Sq > 1, q_offset=pos,
                        kv_len=pos + Sq)
    out = out.reshape(B, Sq, H * hd)
    tap(taps, prefix + ".pre_o", out)
    return dof.qlinear(out, p["wo"], qcfg, stream=p.get("out_stream"),
                       bits=pv.bits("wo"), use_kernels=use_kernels)
