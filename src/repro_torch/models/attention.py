"""GQA attention (+qk-norm, RoPE or M-RoPE, biased q/k/v) with monolithic and
paged int8 KV caches, the encoder-decoder's cross attention, and
DeepSeek-V2's MLA with its monolithic latent cache.

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
from ..kernels.decode_attention import (decode_attention,
                                        decode_attention_paged, kernel_takes)
from ..kernels._library import on_card
from ..kernels.ops import attention_prefill
from ..serve.kv_cache import quantize_kv
from .config import ModelConfig
from .layers import apply_mrope, apply_rope, init_rmsnorm, rmsnorm, tap

Params = dict[str, Any]

_NEG = -1e30


def decode_route(cfg: ModelConfig, max_len: int, use_kernels: bool) -> bool:
    """Whether the per-slot decode attention goes through
    ``kernels.decode_attention`` (``decode_attention_paged`` for the paged
    cache) for a serving cache of depth ``max_len``.

    The single routing predicate: :func:`attention` applies it and
    ``serve.engine.Engine.stats()`` reports it, so they cannot disagree.
    The CUDA kernel masks a ragged last split itself, so unlike the Pallas
    kernel's ``decode_tiles_ok`` it refuses no cache depth or page size —
    only head shapes it was not built for (``kernel_takes``)."""
    G = cfg.n_heads_padded // cfg.n_kv_heads_padded
    return (bool(use_kernels) and cfg.mla is None and max_len >= 1
            and kernel_takes(G, cfg.head_dim))


def prefill_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  use_kernels: bool) -> bool:
    """Whether the cache-free attention of a full-precision model (the
    teacher) goes through ``kernels.ops.attention_prefill`` (the
    ``flash_attention`` kernel): the causal self-attention of a forward
    with no cache, and the encoder-decoder's non-causal cross attention
    (k, v over the encoder's ``Sk`` frames, in every cache mode).

    Only a forward that takes no gradient on the card: the kernel has no
    backward (nor has the reference's), and CPU tensors keep ``_sdpa``.
    :func:`attention` and :func:`cross_attention` never ask it for a
    quantized model: the student trains on ``_sdpa`` (with a gradient), so
    its no-gradient forwards (evaluate) stay on the route it was trained
    on."""
    return (bool(use_kernels) and on_card(q)
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


def _write_rows(c: torch.Tensor, u: torch.Tensor, pos) -> None:
    """Write ``u [B, Sq, ...]`` into the cache ``c [B, T, ...]`` at ``pos``
    (in place).  Per-slot offsets: the start clamps so the write stays
    inside the cache (dead slots keep advancing), as
    ``dynamic_update_slice``.  A scalar offset drops rows past the cache
    end, which can only be bucketed-prefill padding."""
    B, Sq = u.shape[:2]
    T = c.shape[1]
    if _is_vector(pos):
        start = torch.clamp(pos, 0, T - Sq)
        rows = start[:, None] + torch.arange(Sq, device=u.device)[None]
        c[torch.arange(B, device=u.device)[:, None], rows] = u.to(c.dtype)
    else:
        n = min(Sq, T - pos)
        c[:, pos:pos + n] = u[:, :n].to(c.dtype)


def _mask(q_offset, Sq: int, Skv: int, causal: bool, kv_len,
          device) -> torch.Tensor:
    """Which keys each query sees: ``[B, Sq, Skv]`` for per-slot ``[B]``
    offsets (serving: every slot at its own offset, each attending its own
    valid prefix ``kv_len``), else ``[Sq, Skv]``."""
    pos_k = torch.arange(Skv, device=device)
    ar_q = torch.arange(Sq, device=device)
    if _is_vector(q_offset):
        pos_q = q_offset[:, None] + ar_q[None, :]                 # [B, Sq]
        mask = torch.ones((q_offset.shape[0], Sq, Skv), dtype=torch.bool,
                          device=device)
        if causal:
            mask = mask & (pos_q[:, :, None] >= pos_k[None, None, :])
        if kv_len is not None:
            mask = mask & (pos_k[None, None, :] < kv_len[:, None, None])
        return mask
    pos_q = q_offset + ar_q
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    if kv_len is not None:
        mask = mask & (pos_k[None, :] < kv_len)
    return mask


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset, kv_len=None) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Skv,Hkv,hd]; f32 logits and softmax.

    ``q_offset``/``kv_len`` are ints, or per-slot ``[B]`` tensors (see
    :func:`_mask`)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * (hd ** -0.5)
    mask = _mask(q_offset, Sq, Skv, causal, kv_len, q.device)
    if _is_vector(q_offset):
        mask = mask[:, None, None]
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
    lengths = pos + 1
    if decode_route(cfg, n_pg * P, use_kernels):
        # the kernel reads the pools through the page table itself
        qd = q[:, 0].reshape(S, Hkv, H // Hkv, hd).contiguous()
        od = decode_attention_paged(qd, pool_k, pool_v, pt, lengths, ks, vs)
        return od.reshape(S, 1, H, hd)
    # each slot's pages gathered into a transient [S, T, Hkv, hd] int8 view;
    # rows past the slot's length (trash-page garbage included) are masked
    k8 = pool_k[pt].reshape(S, n_pg * P, Hkv, hd)
    v8 = pool_v[pt].reshape(S, n_pg * P, Hkv, hd)
    return _paged_sdpa(q, k8, v8, lengths, ks, vs)


def attention(x: torch.Tensor, p: Params, cfg: ModelConfig,
              qcfg: QuantConfig | None, positions: torch.Tensor,
              cache: Params | None = None, plan=None,
              use_kernels: bool = False, taps: dict | None = None,
              prefix: str = "") -> torch.Tensor:
    """GQA forward; writes this step's K/V into ``cache`` (in place) when one
    is given.  ``positions`` is ``[B, S]``, or ``[B, 3, S]`` under M-RoPE
    (``cfg.mrope_sections``).  Cache modes: none (full sequence, causal);
    monolithic with a scalar ``pos`` (batch prefill); monolithic with a per-slot ``pos [B]``
    (serving decode); paged (``"pt"`` in the cache, serving decode).

    ``use_kernels`` routes the per-slot decode attention through
    ``kernels.decode_attention`` under :func:`decode_route`, the cache-free
    causal attention of a full-precision model's no-gradient forward
    through ``kernels.ops.attention_prefill`` under :func:`prefill_route`
    (``_sdpa`` / ``_paged_sdpa`` are the plain route) and the weights'
    fake-quant through the ``fake_quant`` kernel.  ``taps`` records
    ``{prefix}.pre_o``."""
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
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        # a quantized model (the student) keeps _sdpa, the route it trains on
        if qcfg is None and prefill_route(q, k, v, use_kernels):
            out = attention_prefill(q, k, v, causal=True)
        else:
            out = _sdpa(q, k, v, causal=True, q_offset=0)
    elif "pt" in cache:
        out = _paged_decode(q, k, v, cache, cfg, use_kernels).to(x.dtype)
    else:
        pos, ck, cv = cache["pos"], cache["k"], cache["v"]
        T = ck.shape[1]
        _write_rows(ck, k, pos)
        _write_rows(cv, v, pos)
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


def cross_attention(x: torch.Tensor, enc_out: torch.Tensor | None,
                    p: Params, cfg: ModelConfig, qcfg: QuantConfig | None,
                    cross_kv: tuple | None = None, plan=None,
                    use_kernels: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder's cross attention over the encoder output: no RoPE, no
    mask.  Returns ``(out, k, v)``: k, v ``[B, Sk, Hkv, hd]`` are
    ``cross_kv`` when given (a cache's), else projected from ``enc_out``.
    One ``in_stream`` quantizes both the query's input and the encoder
    output, as in the JAX package (F18).

    ``use_kernels`` routes the weights' fake-quant through the kernel and,
    for a full-precision model under :func:`prefill_route`, the attention
    through ``kernels.ops.attention_prefill`` with ``causal=False`` (it
    reads no cache of its own, so every mode takes it); ``_sdpa`` is the
    plain route."""
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    H, Hkv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    pv = plan_view(plan)
    ins = p.get("in_stream")

    def lin(inp, name):
        return dof.qlinear(inp, p[name], qcfg, stream=ins,
                           bits=pv.bits(name), use_kernels=use_kernels)

    q = lin(x, "wq").reshape(B, Sq, H, hd)
    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = lin(enc_out, "wk").reshape(B, -1, Hkv, hd)
        v = lin(enc_out, "wv").reshape(B, -1, Hkv, hd)
    if qcfg is None and prefill_route(q, k, v, use_kernels):
        out = attention_prefill(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, causal=False, q_offset=0)
    out = dof.qlinear(out.reshape(B, Sq, H * hd), p["wo"], qcfg,
                      stream=p.get("out_stream"), bits=pv.bits("wo"),
                      use_kernels=use_kernels)
    return out, k, v


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV, optional absorbed decode
# --------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig,
             qcfg: QuantConfig | None, lead: tuple = ()) -> Params:
    """The six linears, two norms and (student) four streams, keyed in
    the JAX package's (sorted) order."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads_padded
    dev = gen.device
    p: Params = {
        "q_down": dof.init_qlinear(gen, d, m.q_lora, qcfg, name="q_down",
                                   lead=lead),
        "q_up": dof.init_qlinear(gen, m.q_lora, H * (m.d_nope + m.d_rope),
                                 qcfg, name="q_up", lead=lead),
        "kv_down": dof.init_qlinear(gen, d, m.kv_lora + m.d_rope, qcfg,
                                    name="kv_down", lead=lead),
        "k_up": dof.init_qlinear(gen, m.kv_lora, H * m.d_nope, qcfg,
                                 name="k_up", lead=lead),
        "v_up": dof.init_qlinear(gen, m.kv_lora, H * m.d_v, qcfg,
                                 name="v_up", lead=lead),
        "wo": dof.init_qlinear(gen, H * m.d_v, d, qcfg, name="wo",
                               lead=lead),
        "q_norm": init_rmsnorm(m.q_lora, lead, dev),
        "kv_norm": init_rmsnorm(m.kv_lora, lead, dev),
    }
    if qcfg is not None:
        p["in_stream"] = dof.init_stream(d, lead=lead, device=dev)
        p["q_stream"] = dof.init_stream(m.q_lora, lead=lead, device=dev)
        p["kv_stream"] = dof.init_stream(m.kv_lora, lead=lead, device=dev)
        p["out_stream"] = dof.init_stream(H * m.d_v, lead=lead, device=dev)
    return {k: p[k] for k in sorted(p)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   n_layers: int, dtype=torch.bfloat16,
                   device=None) -> Params:
    """Monolithic latent cache ``ckv [L, B, max_len, kv_lora]`` and ``kr
    [L, B, max_len, d_rope]`` and a scalar (Python int) ``pos``."""
    m = cfg.mla
    return {"ckv": torch.zeros((n_layers, batch, max_len, m.kv_lora),
                               dtype=dtype, device=device),
            "kr": torch.zeros((n_layers, batch, max_len, m.d_rope),
                              dtype=dtype, device=device),
            "pos": 0}


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
            f32: bool = False) -> torch.Tensor:
    """``jnp.einsum``'s dtype rules: the operands promoted to a common
    dtype, or both to f32 (``preferred_element_type=float32``)."""
    dt = torch.float32 if f32 else torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def mla_attention(x: torch.Tensor, p: Params, cfg: ModelConfig,
                  qcfg: QuantConfig | None, positions: torch.Tensor,
                  cache: Params | None = None, plan=None,
                  use_kernels: bool = False) -> torch.Tensor:
    """MLA forward; writes this step's latent ``ckv``/``kr`` into ``cache``
    (in place) when one is given.  Cache modes: none (full sequence,
    causal); a scalar ``pos`` (batch prefill); a per-slot ``pos [B]``
    (serving decode).  ``cfg.mla_absorb`` runs the attention in the latent
    space, with ``k_up`` folded into the query and ``v_up`` into the
    output (each effective weight tied to ``kv_stream``'s ``log_sa``);
    otherwise ``k_up``/``v_up`` expand the whole latent cache.

    The attention itself is plain einsums, as in the JAX package (f32
    logits, the ``-1e30`` mask, softmax in f32 cast to ``x.dtype``): no
    kernel of the repo computes it.  ``use_kernels`` routes the weights'
    fake-quant through the ``fake_quant`` kernel."""
    m = cfg.mla
    B, Sq, _ = x.shape
    H = cfg.n_heads_padded
    pv = plan_view(plan)
    ins = p.get("in_stream")

    def lin(inp, name, stream):
        return dof.qlinear(inp, p[name], qcfg, stream=stream,
                           bits=pv.bits(name), use_kernels=use_kernels)

    ql = rmsnorm(lin(x, "q_down", ins), p["q_norm"])
    q = lin(ql, "q_up", p.get("q_stream"))
    q = q.reshape(B, Sq, H, m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = lin(x, "kv_down", ins)
    ckv, kr = kv[..., : m.kv_lora], kv[..., m.kv_lora:]
    ckv = rmsnorm(ckv, p["kv_norm"])
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        pos = cache["pos"]
        _write_rows(cache["ckv"], ckv, pos)
        _write_rows(cache["kr"], kr, pos)
        ckv_all, kr_all = cache["ckv"], cache["kr"]
        kv_len, q_offset = pos + Sq, pos
    else:
        ckv_all, kr_all, kv_len, q_offset = ckv, kr, None, 0

    scale = (m.d_nope + m.d_rope) ** -0.5
    Skv = ckv_all.shape[1]
    log_sa = None if qcfg is None else p["kv_stream"]["log_sa"]

    def absorbed(name, width):
        w = dof.effective_weight(p[name], qcfg, log_sa, compute_dtype=x.dtype,
                                 bits=pv.bits(name), use_kernels=use_kernels)
        return w.reshape(m.kv_lora, H, width)

    if cfg.mla_absorb:
        q_c = _einsum("bqhn,chn->bqhc", q_nope, absorbed("k_up", m.d_nope))
        logits = _einsum("bqhc,bsc->bhqs", q_c, ckv_all, f32=True)
    else:
        k_nope = lin(ckv_all, "k_up", p.get("kv_stream")).reshape(
            B, Skv, H, m.d_nope)
        logits = _einsum("bqhn,bshn->bhqs", q_nope, k_nope, f32=True)
    logits = (logits + _einsum("bqhr,bsr->bhqs", q_rope, kr_all,
                               f32=True)) * scale

    mask = _mask(q_offset, Sq, Skv, True, kv_len, x.device)
    if _is_vector(q_offset):
        mask = mask[:, None]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)

    if cfg.mla_absorb:
        ctx_c = _einsum("bhqs,bsc->bqhc", probs, ckv_all)     # latent context
        ctx = _einsum("bqhc,chv->bqhv", ctx_c, absorbed("v_up", m.d_v))
    else:
        v = lin(ckv_all, "v_up", p.get("kv_stream")).reshape(B, Skv, H, m.d_v)
        ctx = _einsum("bhqs,bshv->bqhv", probs, v)
    ctx = ctx.reshape(B, Sq, H * m.d_v)
    return lin(ctx, "wo", p.get("out_stream"))
